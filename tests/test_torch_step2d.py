"""The port's 2D family (core/seeding.py::reset2d, core/interp.py::
interp_mac2, solver/step2d.py, solver/apic2d.py) against the JAX package's
and the 2D NumPy oracle, on the CPU.

Against JAX run op by op on the same numpy inputs, made from a seed, at
16^2 and 32^2:
 * init_state2d and init_apic_state2d bit for bit;
 * interp_mac2, advect_rk3, seed_closest, transfer_to_grid,
   extrapolate_full, p2g_apic2d and g2p_apic2d bit for bit;
 * compute_level_set: cpos bit for bit, phi within 2e-6 abs (measured 1.2e-7
   at 16^2 and 9.5e-7 at 32^2; see test_level_set_matches_jax);
 * project: p within 2e-6 x max |p| (the SOR's rounding differs from its
   second iteration on), u and v within 1e-4;
 * step2d and step_apic2d within 1e-4 abs of JAX's jitted steps after one
   and after three steps, C within 2 m x 1e-4 (measured at 16^2 after
   three steps: at most 4.8e-7 on the FLIP fields, 1.1e-6 on APIC's grids,
   8.6e-6 on C).
Against the oracle (reference/solver2d.py): the transfer and the full
extrapolation within 1e-6, as tests/test_step2d.py holds JAX. Ten steps
stay finite and inside the clamp box. A NaN position gives JAX's
non-finite rows and finite grids. JAX's jitted steps compile once a
configuration for the module.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig2D as JaxConfig2D
from fluidsimulation_tpu.core.interp import interp_mac2 as jax_interp_mac2
from fluidsimulation_tpu.reference import solver2d as oracle
from fluidsimulation_tpu.solver import apic2d as japic
from fluidsimulation_tpu.solver import step2d as jstep

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core.interp import interp_mac2
from fluidsimulation_tpu_torch.ops import cuda_sor
from fluidsimulation_tpu_torch.solver import apic2d, step2d

DT = 0.01
BAD = 5  # the particle that gets the NaN
FIELDS = ("pos", "vel", "u", "v", "phi")
APIC_FIELDS = ("pos", "vel", "C", "u", "v", "phi")
STEP_ATOL = 1e-4
SIZES = [16, 32]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _configs(n):
    kw = dict(nx=n, ny=n, cells_per_meter=float(n))
    return ft.SimConfig2D(**kw), JaxConfig2D(**kw)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _step_atol(name, cfg):
    """STEP_ATOL, and for C that bound carried through G2P's lever
    (C = 4 m^2 sum w v (x_i - x_p)): 2 m x STEP_ATOL."""
    return 2 * cfg.nx * STEP_ATOL if name == "C" else STEP_ATOL


def _jax_runs(jcfg, apic, n_steps, nan=False):
    """JAX's initial state (a NaN x in particle BAD if ``nan``) and the
    states after each of n_steps jitted steps."""
    j = (japic.init_apic_state2d if apic else jstep.init_state2d)(jcfg)
    if nan:
        pos = np.array(j.pos)
        pos[BAD, 0] = np.nan
        j = dataclasses.replace(j, pos=jnp.asarray(pos))
    step = japic.step_apic2d_jit if apic else jstep.step2d_jit
    states = [j]
    for _ in range(n_steps):
        states.append(step(states[-1], DT, jcfg))
    return states


@pytest.fixture(scope="module")
def jax_runs():
    """Three jitted JAX steps at each size, FLIP and APIC, run once."""
    return {(n, apic): _jax_runs(_configs(n)[1], apic, 3) for n in SIZES for apic in (False, True)}


def _advected(n):
    """The oracle's dam break at n^2 and its positions after one JAX RK3
    advection of dt (float32 dt, as the jitted step forms it)."""
    _, jcfg = _configs(n)
    pos, vel, u, v = oracle.reset(jcfg)
    new = jstep.advect_rk3(jcfg, jnp.asarray(u), jnp.asarray(v), jnp.asarray(pos),
                           jnp.float32(DT))
    return pos, vel, u, v, np.asarray(new)


@pytest.mark.parametrize("n", SIZES)
def test_init_states_bit_equal_jax(n):
    """reset2d's grids, positions and velocities, phi = +inf, C = 0; the
    numpy converters carry JAX's states in and out bit for bit."""
    cfg, jcfg = _configs(n)
    for init, jinit, fields, to_np, from_np in (
        (ft.init_state2d, jstep.init_state2d, FIELDS, ft.state2d_to_numpy,
         ft.state2d_from_numpy),
        (ft.init_apic_state2d, japic.init_apic_state2d, APIC_FIELDS, ft.apic_state2d_to_numpy,
         ft.apic_state2d_from_numpy),
    ):
        s, j = init(cfg, "cpu"), jinit(jcfg)
        out = to_np(s)
        assert list(out) == list(fields)
        assert s.pos.shape == (cfg.num_particles, 2)
        carried = from_np(j, "cpu")
        for name in fields:
            np.testing.assert_array_equal(out[name], np.asarray(getattr(j, name)), err_msg=name)
            assert torch.equal(getattr(carried, name), getattr(s, name)), name
            assert torch.equal(getattr(s.to("cpu"), name), getattr(s, name)), name


@pytest.mark.parametrize("n", SIZES)
def test_interp_mac2_bit_exact(n):
    """Random grids; queries in [-0.2, 1.2] x n reach every clamp and
    top-edge decrement, plus a NaN query (NaN out, as JAX)."""
    rng = np.random.default_rng(n)
    u = rng.normal(size=(n + 1, n)).astype(np.float32)
    v = rng.normal(size=(n, n + 1)).astype(np.float32)
    q = (rng.uniform(-0.2, 1.2, size=(3000, 2)) * n).astype(np.float32)
    q[:6] = [[0, 0], [n - 1, n - 1], [n, n], [n - 0.5, -0.5], [-1, n + 1], [np.nan, 2.0]]
    want = jax_interp_mac2(*map(jnp.asarray, (u, v, q[:, 0], q[:, 1])))
    got = interp_mac2(*map(_t, (u, v, q[:, 0], q[:, 1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isnan(got[0][5].item()) and np.isnan(got[1][5].item())


@pytest.mark.parametrize("n", SIZES)
def test_advect_rk3_bit_exact(n):
    cfg, _ = _configs(n)
    pos, _, u, v, want = _advected(n)
    got = step2d.advect_rk3(cfg, _t(u), _t(v), _t(pos), DT)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SIZES)
def test_level_set_matches_jax(n):
    """seed_closest (phi and cpos) bit for bit; after the 8 sweeps cpos bit
    for bit and phi within 2e-6 abs. The sweeps' phi differs by an ulp in
    a few cells: XLA compiles the body of JAX's scan and contracts
    ex*ex + ey*ey into a fused multiply-add, fma(ey, ey, ex*ex) (an
    emulated fma gives JAX's bits); the port rounds each
    operation, as its seed (and JAX's, run op by op) does."""
    cfg, jcfg = _configs(n)
    pos = _advected(n)[4]
    for got, want in zip(step2d.seed_closest(cfg, _t(pos)),
                         jstep.seed_closest(jcfg, jnp.asarray(pos))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    phi, cpos = step2d.compute_level_set(cfg, _t(pos))
    jphi, jcpos = jstep.compute_level_set(jcfg, jnp.asarray(pos))
    np.testing.assert_array_equal(cpos.numpy(), np.asarray(jcpos))
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=0, atol=2e-6)
    assert (phi < 0).sum() > 0


@pytest.mark.parametrize("n", SIZES)
def test_transfer_and_extrapolation_bit_exact(n):
    """transfer_to_grid (one index_add_ a node, in JAX's node order) and
    extrapolate_full over nx + ny + 2 fills, bit for bit JAX's."""
    cfg, jcfg = _configs(n)
    _, vel, _, _, pos = _advected(n)
    got = step2d.transfer_to_grid(cfg, _t(pos), _t(vel))
    want = jstep.transfer_to_grid(jcfg, jnp.asarray(pos), jnp.asarray(vel))
    for name, g, w in zip(("u", "v", "uv", "vv"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    iters = n + n + 2
    for g, valid, jg, jvalid in ((got[0], got[2], want[0], want[2]),
                                 (got[1], got[3], want[1], want[3])):
        np.testing.assert_array_equal(step2d.extrapolate_full(g, valid, iters).numpy(),
                                      np.asarray(jstep.extrapolate_full(jg, jvalid, iters)))


@pytest.mark.parametrize("n", SIZES)
def test_transfer_and_extrapolation_match_oracle(n):
    """The oracle's transfer_particles_to_grid (its Manhattan-bucket BFS
    extrapolation included) within 1e-6 abs, as tests/test_step2d.py holds
    JAX."""
    cfg, jcfg = _configs(n)
    ref = oracle.FluidSimRef(jcfg)
    pos = oracle.advect(jcfg, ref.u, ref.v, ref.pos, DT)
    u_r, v_r, _, _ = oracle.transfer_particles_to_grid(jcfg, pos, ref.vel)
    u, v, uv, vv = step2d.transfer_to_grid(cfg, _t(pos), _t(ref.vel))
    iters = n + n + 2
    np.testing.assert_allclose(step2d.extrapolate_full(u, uv, iters).numpy(), u_r, atol=1e-6)
    np.testing.assert_allclose(step2d.extrapolate_full(v, vv, iters).numpy(), v_r, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_project_matches_jax(n):
    """The dam break's grids after transfer and extrapolation, its level
    set: p within 2e-6 x max |p| (measured 6.6e-7 at 16^2, 5.7e-7 at 32^2,
    of max |p| ~ 1e3), u and v within 1e-4 abs. On the CPU the SOR is the
    plain version on (nx, ny, 1) views: no kernel launch."""
    cfg, jcfg = _configs(n)
    _, vel, _, _, pos = _advected(n)
    u, v, uv, vv = step2d.transfer_to_grid(cfg, _t(pos), _t(vel))
    u = step2d.extrapolate_full(u, uv, n + n + 2)
    v = step2d.extrapolate_full(v, vv, n + n + 2)
    phi, _ = step2d.compute_level_set(cfg, _t(pos))
    before = cuda_sor.KERNEL.launches
    got = step2d.project(cfg, u, v, phi, DT)
    assert cuda_sor.KERNEL.launches == before
    want = jstep.project(jcfg, *(jnp.asarray(a.numpy()) for a in (u, v, phi)), jnp.float32(DT))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    p, jp = got[2].numpy(), np.asarray(want[2])
    assert np.abs(jp).max() > 100.0
    assert np.abs(p - jp).max() <= 2e-6 * np.abs(jp).max()


@pytest.mark.parametrize("n", SIZES)
def test_apic2d_transfers_bit_exact(n):
    """p2g_apic2d (random vel and C) and g2p_apic2d (random grids) at the
    advected positions, bit for bit JAX's run op by op."""
    cfg, jcfg = _configs(n)
    pos = _advected(n)[4]
    rng = np.random.default_rng(100 + n)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    C = (5.0 * rng.normal(size=(pos.shape[0], 2, 2))).astype(np.float32)
    got = apic2d.p2g_apic2d(cfg, _t(pos), _t(vel), _t(C))
    want = japic.p2g_apic2d(jcfg, *map(jnp.asarray, (pos, vel, C)))
    for name, g, w in zip(("u", "v", "uv", "vv"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    u = rng.normal(size=(n + 1, n)).astype(np.float32)
    v = rng.normal(size=(n, n + 1)).astype(np.float32)
    got = apic2d.g2p_apic2d(cfg, *map(_t, (pos, u, v)))
    want = japic.g2p_apic2d(jcfg, *map(jnp.asarray, (pos, u, v)))
    assert got[1].shape == (pos.shape[0], 2, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
@pytest.mark.parametrize("n", SIZES)
def test_step_matches_jax(n, apic, jax_runs):
    """From JAX's initial state: after each of three steps every field
    within 1e-4 abs of JAX's jitted step (C within 2 m x 1e-4)."""
    cfg, _ = _configs(n)
    runs = jax_runs[(n, apic)]
    fields = APIC_FIELDS if apic else FIELDS
    s = (ft.apic_state2d_from_numpy if apic else ft.state2d_from_numpy)(runs[0], "cpu")
    step = ft.step_apic2d if apic else ft.step2d
    for k, j in enumerate(runs[1:], start=1):
        s = step(s, DT, cfg)
        for name in fields:
            np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=0, atol=_step_atol(name, cfg),
                                       err_msg=f"step {k}: {name}")


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
def test_multi_step_stable(apic):
    """Ten steps at 16^2 (tests/test_step2d.py::test_step2d_multi_step_stable):
    every field finite, positions inside the advection clamp box."""
    cfg, _ = _configs(16)
    s = (ft.init_apic_state2d if apic else ft.init_state2d)(cfg, "cpu")
    step = ft.step_apic2d if apic else ft.step2d
    for _ in range(10):
        s = step(s, DT, cfg)
    for name in APIC_FIELDS if apic else FIELDS:
        assert bool(getattr(s, name).isfinite().all()), name
    m = torch.tensor([cfg.nx, cfg.ny], dtype=torch.float32)
    assert bool(((s.pos >= -0.4 / m - 1e-6) & (s.pos <= 1 - 0.6 / m + 1e-6)).all())


def _nonfinite_rows(a):
    a = np.asarray(a)
    return np.flatnonzero(~np.isfinite(a.reshape(a.shape[0], -1)).all(axis=1)).tolist()


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
def test_nan_position_steps_like_jax(apic):
    """One NaN x at 16^2, one step against JAX's: the same non-finite rows
    (that particle's pos, and its vel in FLIP and its C in APIC: APIC's
    spline weights of a NaN distance are 0, so its vel stays finite),
    finite grids and phi, every other value within the step bound."""
    cfg, jcfg = _configs(16)
    start, j = _jax_runs(jcfg, apic, 1, nan=True)
    s = (ft.apic_state2d_from_numpy if apic else ft.state2d_from_numpy)(start, "cpu")
    s = (ft.step_apic2d if apic else ft.step2d)(s, DT, cfg)
    keep = np.arange(cfg.num_particles) != BAD
    for name in ("pos", "vel", "C") if apic else ("pos", "vel"):
        want = _nonfinite_rows(getattr(j, name))
        assert want == ([] if apic and name == "vel" else [BAD]), name
        assert _nonfinite_rows(getattr(s, name)) == want, name
        np.testing.assert_allclose(getattr(s, name).numpy()[keep],
                                   np.asarray(getattr(j, name))[keep],
                                   rtol=0, atol=_step_atol(name, cfg), err_msg=name)
    for name in ("u", "v", "phi"):
        got = getattr(s, name).numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, np.asarray(getattr(j, name)), rtol=0, atol=STEP_ATOL,
                                   err_msg=name)
