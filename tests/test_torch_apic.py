"""The port's APIC family (ops/apic.py, ops/advect.py::advect_rk3_pic,
solver/apic.py) against the JAX package's, on the CPU.

Against JAX on the same numpy inputs, made from a seed, at 16^3:
 * p2g_apic bit for bit with JAX's run op by op, at ppc 1 and ppc 2 (one
   index_add_ a node, in JAX's node order, sums each face as XLA's scatter
   of the concatenated nodes does);
 * g2p_apic, vel and C, bit for bit with JAX's run op by op (JAX's jitted
   form fuses multiply-adds, so it is not the reference for bits);
 * advect_rk3_pic within 1e-6 m of JAX's (which interpolates through its
   packed rows, equal up to fused multiply-adds);
 * extrapolate_rings bit for bit;
 * step_apic against JAX's step_apic(fast=False), at ppc 1 and ppc 2: one
   step within 1e-4 abs on every field (the bound the FLIP step is held
   to), and three steps within the same 1e-4 (measured: 7.5e-6 on C, at
   most 3e-7 elsewhere); five steps at 24^3 ppc 1 within the same 1e-4,
   C within 2 m x 1e-4;
 * a NaN position, two steps: the same non-finite rows as JAX's (pos and C
   of that particle; its vel stays finite, as JAX's: its weights are 0) and
   finite grids.
The port's own properties mirror tests/test_apic.py: the spline's partition
of unity, the inertia identity, constant and affine fields through P2G and
G2P, and P2G's momentum conservation. JAX's step compiles once a
configuration (about 18 s each on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.ops import apic as jax_apic
from fluidsimulation_tpu.ops.advect import advect_rk3_pic as jax_advect_rk3_pic
from fluidsimulation_tpu.solver.apic import init_apic_state as jax_init_apic
from fluidsimulation_tpu.solver.apic import step_apic_jit
from fluidsimulation_tpu.utils import checkpoint as jax_cp

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops.advect import advect_rk3_pic
from fluidsimulation_tpu_torch.ops.apic import (
    _component_nodes,
    _quad_spline,
    extrapolate_rings,
    g2p_apic,
    p2g_apic,
)
from fluidsimulation_tpu_torch.utils import checkpoint

N = 16
DT = 0.01
BAD = 5  # the particle that gets the NaN
FIELDS = ("pos", "vel", "C", "u", "v", "w", "phi")
STEP_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _configs(ppc, n=N):
    kw = dict(nx=n, ny=n, nz=n, cells_per_meter=float(n), particles_per_cell_axis=ppc)
    return ft.SimConfig(**kw), JaxConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_steps(jcfg, n_steps, nan=False):
    """The JAX initial state (a NaN position in particle BAD if ``nan``)
    and the states after each of n_steps steps of step_apic(fast=False)."""
    j = jax_init_apic(jcfg)
    if nan:
        pos = np.array(j.pos)
        pos[BAD, 0] = np.nan
        j = dataclasses.replace(j, pos=jnp.asarray(pos))
    states = [j]
    for _ in range(n_steps):
        states.append(step_apic_jit(states[-1], DT, jcfg, fast=False))
    return states


@pytest.fixture(scope="module")
def jax_runs():
    """Three JAX steps at 16^3 for each ppc, run once for the module."""
    return {ppc: _jax_steps(_configs(ppc)[1], 3) for ppc in (1, 2)}


def _random_particles(cfg, seed):
    """Positions over the advection clamp box, random vel and C."""
    rng = np.random.default_rng(seed)
    n = cfg.num_particles
    m = cfg.nx
    pos = rng.uniform(-0.4 / m, 1.0 - 0.6 / m, (n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    C = (5.0 * rng.normal(size=(n, 3, 3))).astype(np.float32)
    return pos, vel, C


@pytest.mark.parametrize("ppc", [1, 2], ids=["ppc1", "ppc2"])
def test_p2g_apic_bit_exact_with_jax(ppc):
    cfg, jcfg = _configs(ppc)
    pos, vel, C = _random_particles(cfg, seed=ppc)
    want = jax_apic.p2g_apic(jcfg, jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(C))
    got = p2g_apic(cfg, _t(pos), _t(vel), _t(C))
    for name, g, w in zip(("u", "v", "w", "uv", "vv", "wv"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("ppc", [1, 2], ids=["ppc1", "ppc2"])
def test_g2p_apic_bit_exact_with_jax(ppc):
    cfg, jcfg = _configs(ppc)
    pos, _, _ = _random_particles(cfg, seed=10 + ppc)
    rng = np.random.default_rng(20 + ppc)
    grids = [rng.normal(size=s).astype(np.float32)
             for s in (cfg.u_shape(), cfg.v_shape(), cfg.w_shape())]
    jvel, jC = jax_apic.g2p_apic(jcfg, jnp.asarray(pos), *map(jnp.asarray, grids))
    vel, C = g2p_apic(cfg, _t(pos), *map(_t, grids))
    assert C.shape == (pos.shape[0], 3, 3)
    np.testing.assert_array_equal(vel.numpy(), np.asarray(jvel))
    np.testing.assert_array_equal(C.numpy(), np.asarray(jC))


def test_advect_rk3_pic_matches_jax(jax_runs):
    """On the state after two JAX steps at ppc 1: stage 1 is the state's
    own velocity in both."""
    cfg, jcfg = _configs(1)
    j = jax_runs[1][2]
    want = jax.jit(jax_advect_rk3_pic, static_argnums=0)(jcfg, j.u, j.v, j.w, j.pos, j.vel, DT)
    got = advect_rk3_pic(cfg, _t(j.u), _t(j.v), _t(j.w), _t(j.pos), _t(j.vel), DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rings", [1, 2, 3])
def test_extrapolate_rings_bit_exact_with_jax(rings):
    rng = np.random.default_rng(rings)
    g = rng.normal(size=(13, 9, 11)).astype(np.float32)
    valid = rng.random((13, 9, 11)) < 0.15
    want = jax_apic.extrapolate_rings(jnp.asarray(g), jnp.asarray(valid), rings)
    got = extrapolate_rings(_t(g), torch.from_numpy(valid), rings)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_and_state_carry_match_jax():
    cfg, jcfg = _configs(2)
    j = jax_init_apic(jcfg)
    s = ft.init_apic_state(cfg, "cpu")
    carried = ft.apic_state_from_numpy(j, "cpu")
    out = ft.apic_state_to_numpy(s)
    assert list(out) == list(FIELDS)
    for name in FIELDS:
        np.testing.assert_array_equal(out[name], np.asarray(getattr(j, name)), err_msg=name)
        assert torch.equal(getattr(carried, name), getattr(s, name)), name
    moved = ft.apic_state_to_numpy(s.to("cpu"))
    for name in FIELDS:
        np.testing.assert_array_equal(moved[name], out[name])


@pytest.mark.parametrize("ppc", [1, 2], ids=["ppc1", "ppc2"])
def test_step_apic_matches_jax(ppc, jax_runs):
    """From JAX's initial state: after each of three steps every field
    within STEP_ATOL of JAX's step_apic(fast=False)."""
    cfg, _ = _configs(ppc)
    runs = jax_runs[ppc]
    s = ft.apic_state_from_numpy(runs[0], "cpu")
    for k, j in enumerate(runs[1:], start=1):
        s = ft.step_apic(s, DT, cfg)
        for name in FIELDS:
            np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=0, atol=STEP_ATOL, err_msg=f"step {k}: {name}")


def test_five_steps_apic_match_jax_24():
    """Five steps at 24^3 ppc 1 from JAX's initial state: every field within
    STEP_ATOL of JAX's step_apic(fast=False), C within 2 m x STEP_ATOL, the
    bound tests/test_torch_cuda.py::_apic_close holds on the card (C = 4 m^2
    B grows with m; measured 3.6e-5)."""
    cfg, jcfg = _configs(1, n=24)
    runs = _jax_steps(jcfg, 5)
    s = ft.apic_state_from_numpy(runs[0], "cpu")
    for _ in range(5):
        s = ft.step_apic(s, DT, cfg)
    for name in FIELDS:
        atol = 2 * cfg.nx * STEP_ATOL if name == "C" else STEP_ATOL
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(runs[-1], name)),
                                   rtol=0, atol=atol, err_msg=name)


def _nonfinite_rows(a):
    a = np.asarray(a)
    return np.flatnonzero(~np.isfinite(a.reshape(a.shape[0], -1)).all(axis=1)).tolist()


def test_nan_position_steps_like_jax():
    """One NaN position, two steps at ppc 1: the rows JAX leaves non-finite
    (pos and C of that particle) and no others, finite grids, and every
    other value within STEP_ATOL of JAX's."""
    cfg, jcfg = _configs(1)
    runs = _jax_steps(jcfg, 2, nan=True)
    s = ft.apic_state_from_numpy(runs[0], "cpu")
    keep = np.arange(cfg.num_particles) != BAD
    for j in runs[1:]:
        s = ft.step_apic(s, DT, cfg)
        for name in ("pos", "vel", "C"):
            want = _nonfinite_rows(getattr(j, name))
            assert want == ([] if name == "vel" else [BAD]), name
            assert _nonfinite_rows(getattr(s, name)) == want, name
            np.testing.assert_allclose(getattr(s, name).numpy()[keep],
                                       np.asarray(getattr(j, name))[keep],
                                       rtol=0, atol=STEP_ATOL, err_msg=name)
        for name in ("u", "v", "w", "phi"):
            assert bool(getattr(s, name).isfinite().all()), name
            np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=0, atol=STEP_ATOL, err_msg=name)


def test_apic_checkpoints_load_in_both_packages(tmp_path, jax_runs):
    """A JAX APIC checkpoint loads in the port bit for bit, and the port's
    loads in JAX; both check the recorded config."""
    cfg, jcfg = _configs(1)
    j = jax_runs[1][1]
    path = str(tmp_path / "jax.npz")
    jax_cp.save_apic_state(path, j, jcfg)
    s = checkpoint.load_apic_state(path, "cpu", cfg)
    assert isinstance(s, ft.ApicState)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(s, name).numpy(), np.asarray(getattr(j, name)))
    s = ft.step_apic(s, DT, cfg)
    again = str(tmp_path / "port.npz")
    checkpoint.save_apic_state(again, s, cfg)
    back = jax_cp.load_apic_state(again, jcfg)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)), getattr(s, name).numpy())
    small, jsmall = _configs(1, n=8)
    with pytest.raises(ValueError, match="cfg"):
        checkpoint.load_apic_state(path, "cpu", small)
    with pytest.raises(ValueError, match="cfg"):
        jax_cp.load_apic_state(again, jsmall)


# -- the port's own properties (tests/test_apic.py) ---------------------------

def _block_particles(cfg, lo=0.3, hi=0.7, ppc=2, seed=0):
    """A dense jittered block of particles in [lo, hi]^3 (meters)."""
    rng = np.random.default_rng(seed)
    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
    cells = np.stack(np.meshgrid(*[np.arange(int(lo * d), int(hi * d)) for d in m],
                                 indexing="ij"), -1).reshape(-1, 3)
    sub = np.stack(np.meshgrid(*[np.arange(ppc)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pc = (cells[:, None, :] + (sub[None, :, :] + 0.5) / ppc - 0.5
          + rng.uniform(-0.2, 0.2, (len(cells), len(sub), 3))).reshape(-1, 3)
    return _t(pc / m)


def test_quad_spline_properties():
    t = torch.linspace(-0.49, 0.49, 21) + 7.0
    base = torch.floor(t - 0.5)
    nodes = [base + o for o in (0, 1, 2)]
    w = [_quad_spline(t - x) for x in nodes]
    torch.testing.assert_close(sum(w), torch.ones_like(t), rtol=0, atol=1e-6)
    torch.testing.assert_close(sum(wi * xi for wi, xi in zip(w, nodes)), t, rtol=0, atol=1e-5)
    second = sum(wi * (xi - t) ** 2 for wi, xi in zip(w, nodes))
    torch.testing.assert_close(second, torch.full_like(t, 0.25), rtol=0, atol=1e-6)


def test_inertia_identity_all_components():
    cfg, _ = _configs(1)
    m = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.float32)
    rng = np.random.default_rng(1)
    pc = _t(rng.uniform(0.3, 0.7, (64, 3))) * m
    for comp in range(3):
        D = torch.zeros((64, 3, 3))
        for _, ok, w, dxm in _component_nodes(cfg, pc, comp):
            assert bool(ok.all())
            for a in range(3):
                for b in range(3):
                    D[:, a, b] += w * dxm[a] * dxm[b]
        want = torch.diag(0.25 / m**2).expand(64, 3, 3)
        torch.testing.assert_close(D, want, rtol=0, atol=1e-8)


def test_constant_field_transfers_exactly():
    cfg, _ = _configs(1)
    pos = _block_particles(cfg)
    n = pos.shape[0]
    v0 = torch.tensor([0.3, -0.2, 0.1])
    u, v, w, uv, vv, wv = p2g_apic(cfg, pos, v0.expand(n, 3).contiguous(), torch.zeros(n, 3, 3))
    assert bool(uv[1:-1].any())
    for g, valid, axis, value in ((u, uv, 0, 0.3), (v, vv, 1, -0.2), (w, wv, 2, 0.1)):
        inner = g.narrow(axis, 1, g.shape[axis] - 2)[valid.narrow(axis, 1, g.shape[axis] - 2)]
        torch.testing.assert_close(inner, torch.full_like(inner, value), rtol=0, atol=1e-5)


def test_affine_field_roundtrips_exactly():
    """v(x) = v0 + A (x - x0): P2G gives the affine field on every covered
    interior face, and G2P gives back vel and C inside the block."""
    cfg, _ = _configs(1)
    pos = _block_particles(cfg, lo=0.2, hi=0.8)
    n = pos.shape[0]
    v0 = torch.tensor([0.05, -0.1, 0.2])
    x0 = torch.tensor([0.5, 0.5, 0.5])
    A = torch.tensor([[0.3, 1.5, -0.7], [-1.5, 0.1, 0.4], [0.7, -0.4, -0.2]])
    vel = v0 + (pos - x0) @ A.T
    C = A.expand(n, 3, 3).contiguous()
    u, v, w, uv, _, _ = p2g_apic(cfg, pos, vel, C)

    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
    idx = np.argwhere(uv.numpy())
    idx = idx[(idx[:, 0] > 0) & (idx[:, 0] < cfg.nx)]
    xs = np.stack([(idx[:, 0] - 0.5) / m[0], idx[:, 1] / m[1], idx[:, 2] / m[2]], -1)
    want_u = v0[0].item() + (xs - x0.numpy()) @ A[0].numpy()
    np.testing.assert_allclose(u.numpy()[tuple(idx.T)], want_u, atol=2e-4)

    vel2, C2 = g2p_apic(cfg, pos, u, v, w)
    pn = pos.numpy()
    margin = 2.5 / m[0]
    inner = torch.from_numpy(np.all((pn > pn.min(0) + margin) & (pn < pn.max(0) - margin), 1))
    assert int(inner.sum()) > 100
    torch.testing.assert_close(vel2[inner], vel[inner], rtol=0, atol=2e-4)
    torch.testing.assert_close(C2[inner], C[inner], rtol=0, atol=2e-2)


def test_p2g_conserves_momentum():
    """Over the 27 nodes of an interior particle, sum_i w_ip (v_p + C_p
    (x_i - x_p)) = v_p: the weights sum to 1 and the lever arms to 0, so
    P2G moves each particle's momentum to the faces whole."""
    cfg, _ = _configs(1)
    rng = np.random.default_rng(3)
    m = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.float32)
    pos = _t(rng.uniform(0.2, 0.8, (200, 3)))
    vel = _t(rng.normal(size=(200, 3)))
    C = _t(5.0 * rng.normal(size=(200, 3, 3)))
    for comp in range(3):
        total = torch.zeros(200, dtype=torch.float64)
        lever = torch.zeros(200, 3, dtype=torch.float64)
        for _, ok, w, dxm in _component_nodes(cfg, pos * m, comp):
            assert bool(ok.all())
            val = vel[:, comp] + sum(C[:, comp, a] * dxm[a] for a in range(3))
            total += (w * val).double()
            lever += (w[:, None] * torch.stack(dxm, -1)).double()
        torch.testing.assert_close(total, vel[:, comp].double(), rtol=0, atol=1e-5)
        torch.testing.assert_close(lever, torch.zeros_like(lever), rtol=0, atol=1e-8)
