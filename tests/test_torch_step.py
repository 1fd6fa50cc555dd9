"""PyTorch port vs the JAX package: FLIP gather, projection, and the whole
3D step (one step, five steps at 16^3 and at 24^3 ppc 1 and 2, the golden
file).

The port runs its plain versions on CPU tensors; the JAX side runs
``step_jit(fast=False)`` (its exact path) and, for the FLIP gather, the
Pallas pair pack in interpret mode."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.seeding import dam_break_particles, noise_grids
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.ops.flip import flip_update_carry as jax_flip_carry
from fluidsimulation_tpu.ops.levelset import compute_level_set as jax_level_set
from fluidsimulation_tpu.ops.project import project as jax_project
from fluidsimulation_tpu.solver.step3d import step_jit

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import cuda_g2p, cuda_interp, cuda_p2g, cuda_seed, cuda_sor, cuda_sweep
from fluidsimulation_tpu_torch.ops.binning import build_csr, sort_particles
from fluidsimulation_tpu_torch.ops.flip import flip_update, flip_update_carry
from fluidsimulation_tpu_torch.ops.project import project
from fluidsimulation_tpu_torch.solver.step3d import clamp_dt, pic_flip_alpha, step_guarded

N = 16
KW = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N))
CFG, JCFG = ft.SimConfig(**KW), JaxConfig(**KW)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "step16_r1.npz")
FIELDS = ("pos", "vel", "u", "v", "w", "phi")
KERNELS = (cuda_seed, cuda_sweep, cuda_p2g, cuda_sor, cuda_g2p, cuda_interp)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def same(a, b):
    """Equal values, NaN where the other has NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def test_flip_update_carry_matches_jax_pairpack():
    """Inputs of tests/test_pallas_pairpack.py::
    test_flip_update_carry_pallas_routing_bit_identical. Bound 1e-5 abs on
    vel and k1 (measured 0 here: both interpolate pointwise-equal values)."""
    nx = ny = nz = N
    rng = np.random.default_rng(3)
    n = 500
    pos = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    shapes = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    new = [rng.normal(size=s).astype(np.float32) for s in shapes]
    old = [rng.normal(size=s).astype(np.float32) for s in shapes]
    alpha = np.float32(0.03)

    jv, jcache = jax_flip_carry(JCFG, jnp.asarray(pos), jnp.asarray(vel),
                                *map(jnp.asarray, new), *map(jnp.asarray, old),
                                jnp.float32(alpha), pallas=True)
    args = (t(pos), t(vel), *map(t, new), *map(t, old), alpha)
    v, k1 = flip_update_carry(CFG, *args)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(k1.numpy(), np.asarray(jcache.k1), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(flip_update(CFG, *args).numpy(), v.numpy())


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_particle"])
@pytest.mark.parametrize("ppc", [1, 2], ids=["ppc1", "ppc2"])
def test_flip_csr_walk_matches_jax(ppc, nan):
    """The FLIP gather's CPU route in CSR order: with the step's sorted
    particles and without (it then builds the CSR index), bit-equal to each
    other; within 1e-5 abs of JAX's flip_update_carry(pallas=True) on the
    dam break at 16^3 with normal grids. With ``nan``, particle 5 has a NaN
    x: its vel' and k1 are NaN, every other particle's are bit for bit
    those of the call without the NaN."""
    kw = dict(KW, particles_per_cell_axis=ppc)
    cfg, jcfg = ft.SimConfig(**kw), JaxConfig(**kw)
    pos, _ = dam_break_particles(jcfg)
    rng = np.random.default_rng(10 + ppc)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    new = [rng.normal(size=s).astype(np.float32) for s in (cfg.u_shape(), cfg.v_shape(), cfg.w_shape())]
    old = [rng.normal(size=g.shape).astype(np.float32) for g in new]
    alpha = np.float32(0.03)
    bad = pos.copy()
    if nan:
        bad[5, 0] = np.nan
    tp, tv = t(bad), t(vel)
    grids = (*map(t, new), *map(t, old))
    walk = sort_particles(cfg, build_csr(cfg, tp), tp, tv)
    got = flip_update_carry(cfg, tp, tv, *grids, alpha, walk)
    alone = flip_update_carry(cfg, tp, tv, *grids, alpha)
    assert all(same(a, b) for a, b in zip(got, alone))

    jv, jcache = jax_flip_carry(jcfg, jnp.asarray(pos), jnp.asarray(vel), *map(jnp.asarray, new),
                                *map(jnp.asarray, old), jnp.float32(alpha), pallas=True)
    keep = np.arange(pos.shape[0]) != 5 if nan else np.ones(pos.shape[0], dtype=bool)
    for mine, theirs in zip(got, (jv, jcache.k1)):
        np.testing.assert_allclose(mine.numpy()[keep], np.asarray(theirs)[keep], rtol=0, atol=1e-5)
    if nan:
        clean = flip_update_carry(cfg, t(pos), tv, *grids, alpha)
        for mine, ref in zip(got, clean):
            assert bool(mine[5].isnan().all())
            assert torch.equal(mine[torch.from_numpy(keep)], ref[torch.from_numpy(keep)])


def test_project_matches_jax():
    """Noise grids and the dam break's level set. Bound 1e-4 abs on the
    velocities (measured 1.8e-7). The pressure is of order 1e3 here, so it
    is held relative to its largest value: 1e-6, a few float32 ulp
    (measured 3.6e-7; the SOR rounds differently from its second
    iteration on)."""
    u, v, w = noise_grids(JCFG, seed=7)
    pos, _ = dam_break_particles(JCFG)
    phi = np.asarray(jax_level_set(JCFG, jnp.asarray(pos))[0])
    dt = 0.01
    want = jax_project(JCFG, *map(jnp.asarray, (u, v, w, phi)), dt)
    got = project(CFG, *map(t, (u, v, w, phi)), dt)
    for g, j in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-4)
    p, jp = got[3].numpy(), np.asarray(want[3])
    assert np.abs(p - jp).max() <= 1e-6 * np.abs(jp).max()


def _jax_steps(n, jcfg=JCFG):
    s = jax_init(jcfg)
    for _ in range(n):
        s = step_jit(s, 0.01, jcfg, fast=False)
    return s


def test_one_step_matches_jax_and_golden():
    """One dam-break step at dt = 0.01 with k1 carried, against JAX's exact
    path and the golden file. Bound 1e-4 abs, the bound JAX holds between
    its own two paths (tests/test_step3d.py::test_fast_slow_equivalence)."""
    before = [k.KERNEL.launches for k in KERNELS]
    out = ft.state_to_numpy(ft.step(ft.init_state(CFG, "cpu"), 0.01, CFG))
    assert [k.KERNEL.launches for k in KERNELS] == before  # CPU: plain versions
    j = _jax_steps(1)
    with np.load(GOLDEN) as golden:
        for name in FIELDS:
            np.testing.assert_allclose(out[name], np.asarray(getattr(j, name)), rtol=0,
                                       atol=1e-4, err_msg=name)
            np.testing.assert_allclose(out[name], golden[name], rtol=0, atol=1e-4,
                                       err_msg=name)
    np.testing.assert_allclose(out["k1"], np.asarray(j.cache.k1), rtol=0, atol=1e-4)


def _five_steps_close(cfg, jcfg):
    """Five guarded steps at dt = 0.01 against JAX's step_jit(fast=False):
    every field within 1e-4 abs (measured at most 1.6e-5, 24^3 ppc 2)."""
    s = ft.init_state(cfg, "cpu")
    for _ in range(5):
        s, healthy = step_guarded(s, 0.01, cfg)
        assert bool(healthy)
    j = _jax_steps(5, jcfg)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    return s, j


def test_five_steps_match_jax():
    """Five steps at 16^3 ppc 2: every field within 1e-4 abs, and the
    velocities by quantiles as in tests/test_step3d.py beside it."""
    s, j = _five_steps_close(CFG, JCFG)
    dv = np.abs(s.vel.numpy() - np.asarray(j.vel))
    assert np.quantile(dv, 0.5) < 1e-3, np.quantile(dv, [0.5, 0.95, 1.0])
    assert np.quantile(dv, 0.95) < 6e-3
    assert dv.max() < 0.25


@pytest.mark.parametrize("ppc", [1, 2], ids=["ppc1", "ppc2"])
def test_five_steps_match_jax_24(ppc):
    """Five steps at 24^3 (a grid that is not a power of two), ppc 1 and
    ppc 2: every field within 1e-4 abs of JAX's."""
    kw = dict(nx=24, ny=24, nz=24, cells_per_meter=24.0, particles_per_cell_axis=ppc)
    _five_steps_close(ft.SimConfig(**kw), JaxConfig(**kw))


def test_step_without_k1_matches_with_k1():
    """A state without k1 computes RK3 stage 1 itself and steps to the same
    fields (k1 on zero grids is zero)."""
    a = ft.step(ft.init_state(CFG, "cpu"), 0.01, CFG)
    b = ft.step(ft.init_state(CFG, "cpu", with_cache=False), 0.01, CFG)
    assert b.k1 is None
    for name in FIELDS:
        torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=0)


def test_dt_and_alpha():
    assert clamp_dt(CFG, 1.0) == pytest.approx(1.0 / 15.0)
    assert clamp_dt(CFG, -1.0) == 0.0
    assert clamp_dt(CFG, 0.05, simulation_rate=0.5) == pytest.approx(0.025)
    a = pic_flip_alpha(CFG, 1.0 / 60.0)
    assert a.dtype == np.float32
    assert a == pytest.approx(6 * (1 / 60) * CFG.nu * CFG.cells_per_meter**2, rel=1e-5)
    assert pic_flip_alpha(CFG, 1e9) == 1.0
