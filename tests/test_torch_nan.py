"""The NaN rule of the PyTorch port: NaN in, NaN out, no raise.

JAX's step carries a particle whose position is not finite without raising:
``step_guarded`` reports the state unhealthy, that particle stays NaN and
every grid stays finite, so the demo's ``check_state`` can reset the run.
The port keeps the same rule: such a particle sorts past every cell of the
CSR index (ops/binning.py), so no grid stage reads it, and its own
interpolations return NaN (core/interp.py). Here, at 16^3 on the CPU, the
port's step is held to JAX's exact path (``fast=False``) on a state with one
NaN position, at ppc 1 and ppc 2: the same particle non-finite, every grid
finite, every other particle within 1e-4 abs (the bound of
tests/test_torch_step.py). The units check that no finite result moves by
a bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.solver.step3d import step_guarded as jax_step_guarded

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core.interp import interp_mac3
from fluidsimulation_tpu_torch.ops import cuda_p2g
from fluidsimulation_tpu_torch.ops.binning import build_csr
from fluidsimulation_tpu_torch.ops.common import cell_of, far_cell
from fluidsimulation_tpu_torch.ops.levelset import seed_own_cell
from fluidsimulation_tpu_torch.solver.step3d import step_guarded

N = 16
BAD = 5  # the particle that gets the NaN
GRIDS = ("u", "v", "w", "phi")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _configs(ppc):
    kw = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N), particles_per_cell_axis=ppc)
    return ft.SimConfig(**kw), JaxConfig(**kw)


def _nonfinite_rows(a):
    return np.flatnonzero(~np.isfinite(np.asarray(a)).all(axis=1)).tolist()


@pytest.mark.parametrize("ppc", [1, 2], ids=["ppc1", "ppc2"])
def test_nan_position_steps_like_jax(ppc):
    cfg, jcfg = _configs(ppc)
    s = ft.init_state(cfg, "cpu")
    s.pos[BAD, 0] = float("nan")
    j = jax_init(jcfg)
    jpos = np.array(j.pos)
    jpos[BAD, 0] = np.nan
    j = dataclasses.replace(j, pos=jnp.asarray(jpos))
    for _ in range(2):
        s, healthy = step_guarded(s, 0.01, cfg)
        j, jhealthy = jax_step_guarded(j, 0.01, jcfg, fast=False)
        assert not bool(healthy) and not bool(jhealthy)
        for name in ("pos", "vel"):
            assert _nonfinite_rows(getattr(s, name)) == [BAD]
            assert _nonfinite_rows(getattr(j, name)) == [BAD]
        for name in GRIDS:
            assert bool(getattr(s, name).isfinite().all()), name
            assert bool(np.isfinite(np.asarray(getattr(j, name))).all()), name
    keep = np.arange(s.pos.shape[0]) != BAD
    for name in ("pos", "vel", "k1"):
        got = getattr(s, name).numpy()
        want = np.asarray(j.cache.k1 if name == "k1" else getattr(j, name))
        np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-4, err_msg=name)
    for name in GRIDS:
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("ppc", [1, 2], ids=["ppc1", "ppc2"])
def test_nan_velocity_steps_without_raising(ppc):
    """A NaN velocity spreads through P2G to the grids (a gather adds zero
    weights and so reaches more faces than JAX's scatter: the set of
    non-finite faces is not compared). The step must not raise, and the
    guard must say so."""
    cfg, _ = _configs(ppc)
    s = ft.init_state(cfg, "cpu")
    s.vel[BAD, 1] = float("nan")
    for _ in range(2):
        s, healthy = step_guarded(s, 0.01, cfg)
        assert not bool(healthy)


def test_interp_mac3_nan_positions():
    """NaN where a coordinate is NaN (at any axis, also past the edges);
    every other result bit-equal to the same call without the NaNs."""
    rng = np.random.default_rng(11)
    shapes = ((N + 1, N, N), (N, N + 1, N), (N, N, N + 1))
    u, v, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes)
    p = torch.from_numpy(rng.uniform(-1.0, N + 1.0, size=(200, 3)).astype(np.float32))
    want = interp_mac3(u, v, w, *p.unbind(1))
    bad = p.clone()
    rows = torch.tensor([0, 7, 50, 51, 199])
    bad[rows, torch.tensor([0, 1, 2, 0, 1])] = float("nan")
    bad[51, 2] = float("nan")
    got = interp_mac3(u, v, w, *bad.unbind(1))
    hit = torch.zeros(200, dtype=torch.bool)
    hit[rows] = True
    for g, ref in zip(got, want):
        assert bool(g[hit].isnan().all())
        assert torch.equal(g[~hit], ref[~hit])


def test_build_csr_puts_nan_past_the_last_cell():
    cfg, _ = _configs(1)
    pos = ft.init_state(cfg, "cpu").pos
    ncell = N**3
    bad = pos.clone()
    bad[BAD, 1] = float("nan")
    bad[9, 2] = float("inf")
    csr = build_csr(cfg, bad)
    n = pos.shape[0]
    assert int(csr.start[ncell]) == n - 2
    assert csr.order[n - 2:].tolist() == [BAD, 9]
    assert bool((csr.cell[n - 2:] == ncell).all())
    # Every real cell holds what it holds without the two particles.
    keep = torch.tensor([i for i in range(n) if i not in (BAD, 9)])
    clean = build_csr(cfg, pos[keep])
    assert torch.equal(csr.start, clean.start)
    assert torch.equal(csr.cell[: n - 2], clean.cell)
    assert torch.equal(keep[clean.order], csr.order[: n - 2])


@pytest.mark.parametrize("shape", [(16, 16, 16), (1000, 1000, 1001), (1024, 1024, 1024),
                                   (2048, 2048, 2048), (1, 1, 5000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_far_cell_is_past_every_cell(shape):
    """The far cell is exact in float32 and takes the linear id of a particle
    with only its z coordinate non-finite, at cx = cy = 0, to ncell or past,
    also where ncell is over 10^9."""
    nx, ny, nz = shape
    cfg = dataclasses.replace(ft.SimConfig(), nx=nx, ny=ny, nz=nz)
    far = far_cell(cfg)
    assert float(torch.tensor(far, dtype=torch.float32)) == far
    c = cell_of(torch.tensor([[0.0, 0.0, float("nan")]]), far)
    assert int((c[0, 0] * ny + c[0, 1]) * nz + c[0, 2]) >= nx * ny * nz


def test_build_csr_puts_a_nan_z_at_the_first_column_past_the_last_cell():
    """Only z is NaN, and x and y are in the first cell: the particle still
    sorts past every cell, on a grid with one x-y column."""
    cfg = dataclasses.replace(ft.SimConfig(), nx=1, ny=1, nz=40)
    pos = torch.rand(50, 3, generator=torch.Generator().manual_seed(3))
    pos *= torch.tensor([0.45, 0.45, 0.97])
    pos[7, 2] = float("nan")
    csr = build_csr(cfg, pos)
    assert int(csr.start[40]) == 49
    assert int(csr.order[-1]) == 7 and int(csr.cell[-1]) == 40


def test_nan_particle_takes_no_part_in_seed_or_p2g():
    """The own-cell seed and the plain P2G scatter (the CPU path of the P2G
    kernel) give bit for bit what they give without the particle, also
    when its velocity is NaN too."""
    cfg, _ = _configs(1)
    s = ft.init_state(cfg, "cpu")
    rng = np.random.default_rng(3)
    vel = torch.from_numpy(rng.normal(size=tuple(s.pos.shape)).astype(np.float32))
    pos = s.pos.clone()
    pos[BAD] = float("nan")
    vel_bad = vel.clone()
    vel_bad[BAD] = float("nan")
    keep = torch.arange(pos.shape[0]) != BAD

    def seed(p):
        csr = build_csr(cfg, p)
        return seed_own_cell(cfg, csr, (p * N)[csr.order])

    assert torch.equal(seed(pos), seed(s.pos[keep]))
    got = cuda_p2g.p2g_accumulate_plain(cfg, pos * N, vel_bad)
    want = cuda_p2g.p2g_accumulate_plain(cfg, s.pos[keep] * N, vel[keep])
    for (acc, amt), (acc_w, amt_w) in zip(got, want):
        assert torch.equal(acc, acc_w) and torch.equal(amt, amt_w)
