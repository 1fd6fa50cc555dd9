"""PyTorch port vs the JAX package at two particles per cell axis (ppc 2),
the demo's density.

At ppc >= 2 the JAX fast step leaves supercells for the per-cell slot table
and its Pallas kernel ops/pallas_p2g.py::p2g_accumulate_pallas
(solver/step3d.py:216-222). The port keeps one P2G, the gather over the CSR
index (ops/cuda_p2g.py), whose walk over the 18 window cells is exact at any
occupancy. Here its plain version (the CPU path) is held to that Pallas
kernel in interpret mode, and the port's step at ppc 2 to JAX's exact path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.seeding import dam_break_particles, noise_grids
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.ops import celltable as ct
from fluidsimulation_tpu.ops import pallas_p2g as pp
from fluidsimulation_tpu.reference import solver3d
from fluidsimulation_tpu.solver.step3d import step_jit

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import cuda_p2g
from fluidsimulation_tpu_torch.ops.binning import build_csr
from fluidsimulation_tpu_torch.ops.p2g import p2g_from_csr
from fluidsimulation_tpu_torch.solver.step3d import step_guarded

N = 16
KW = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N), particles_per_cell_axis=2)
CFG, JCFG = ft.SimConfig(**KW), JaxConfig(**KW)
FIELDS = ("pos", "vel", "u", "v", "w", "phi")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_p2g_from_csr_matches_pallas_cell_table():
    """Inputs of tests/test_pallas_p2g.py:22-40 (10,976 particles, 8 a
    cell): dam-break positions, velocities sampled from noise grids. The
    Pallas kernel returns cell-indexed accumulators padded by one face
    (pallas_p2g.py:147-152); the port's are face-indexed. Bound: validity
    equal, rtol = atol = 2e-4 on valid faces."""
    pos, _ = dam_break_particles(JCFG)
    assert pos.shape[0] == CFG.num_particles == 10976
    u, v, w = noise_grids(JCFG, seed=7)
    vel = np.stack(
        solver3d.interp_mac(u, v, w, N * pos[:, 0], N * pos[:, 1], N * pos[:, 2]), axis=-1
    ).astype(np.float32)
    tp, tv = torch.from_numpy(pos), torch.from_numpy(vel)
    before = cuda_p2g.KERNEL.launches
    got = p2g_from_csr(CFG, build_csr(CFG, tp), tp, tv)
    assert cuda_p2g.KERNEL.launches == before  # CPU: the plain version

    jp, jv = jnp.asarray(pos), jnp.asarray(vel)
    want = pp.p2g_from_table_pallas(JCFG, ct.build_cell_table(JCFG, jp, jv), jp, jv)
    for i in range(3):
        valid = np.asarray(want[3 + i])
        np.testing.assert_array_equal(got[3 + i].numpy(), valid)
        assert valid.sum() > 1000
        np.testing.assert_allclose(got[i].numpy()[valid], np.asarray(want[i])[valid],
                                   rtol=2e-4, atol=2e-4)


def _jax_steps(s, n):
    for _ in range(n):
        s = step_jit(s, 0.01, JCFG, fast=False)
    return s


@pytest.fixture(scope="module")
def moving():
    """A ppc-2 state three JAX steps into the collapse (particles moving,
    grids non-zero), carried into the port with its k1."""
    return _jax_steps(jax_init(JCFG), 3)


def test_one_step_from_moving_state_matches_jax(moving):
    """One step from the moving state. Bound 1e-4 abs on every field and
    k1, the bound JAX holds between its own two paths
    (tests/test_step3d.py::test_fast_slow_equivalence)."""
    out = ft.state_to_numpy(ft.step(ft.state_from_numpy(moving, "cpu"), 0.01, CFG))
    j = _jax_steps(moving, 1)
    for name in FIELDS:
        np.testing.assert_allclose(out[name], np.asarray(getattr(j, name)), rtol=0,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(out["k1"], np.asarray(j.cache.k1), rtol=0, atol=1e-4)


def test_five_steps_from_moving_state_match_jax(moving):
    """Five steps. P2G sums in another order, which feeds the SOR, so the
    velocities are held by quantiles as in tests/test_torch_step.py."""
    s = ft.state_from_numpy(moving, "cpu")
    for _ in range(5):
        s, healthy = step_guarded(s, 0.01, CFG)
        assert bool(healthy)
    j = _jax_steps(moving, 5)
    np.testing.assert_allclose(s.pos.numpy(), np.asarray(j.pos), rtol=0, atol=1e-4)
    dv = np.abs(s.vel.numpy() - np.asarray(j.vel))
    assert np.quantile(dv, 0.5) < 1e-3, np.quantile(dv, [0.5, 0.95, 1.0])
    assert np.quantile(dv, 0.95) < 6e-3
    assert dv.max() < 0.25
