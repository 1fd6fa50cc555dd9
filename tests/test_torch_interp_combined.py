"""PyTorch port vs the JAX package: the combined-key pack and interpolation.

The same numpy inputs go through both packages on the CPU. The port's pack
is its plain PyTorch version here (csrc/pack.cu is held against it on the
card, tests/test_torch_cuda.py); JAX's Pallas pack runs in interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.core.interp_combined import interp_mac3_combined as jax_interp_combined
from fluidsimulation_tpu.core.interp_combined import pack_mac3_combined as jax_pack
from fluidsimulation_tpu.core.pallas_pack import pack_mac3_combined_pallas as jax_pack_pallas

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.core import cuda_pack
from fluidsimulation_tpu_torch.core.interp import interp_mac3
from fluidsimulation_tpu_torch.core.interp_combined import (
    interp_mac3_combined,
    interp_mac3_combined_vec,
    pack_mac3_combined,
)
from fluidsimulation_tpu_torch.ops.advect import advect_rk3_cached
from fluidsimulation_tpu_torch.utils.profiling import hooked

ROOT = Path(__file__).resolve().parent.parent
NX, NY, NZ = 12, 8, 16


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _grids(shape=(NX, NY, NZ), seed=0):
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]


# Bits that a copy must keep: quiet NaN, a negative NaN with a payload,
# +inf, -inf and -0.0.
SPECIAL_BITS = np.array([0x7FC00000, 0xFFC12345, 0x7F800000, 0xFF800000, 0x80000000],
                        dtype=np.uint32)


def _special_grids(shape, seed):
    """Random grids whose first and last layer along every axis (the faces
    next to the pack's zero halo, and the z ends) hold NaN, +-inf and -0.0."""
    rng = np.random.default_rng(seed)
    grids = _grids(shape, seed)
    for g in grids:
        for axis in range(3):
            for end in (0, -1):
                face = [slice(None)] * 3
                face[axis] = end
                pick = rng.integers(0, len(SPECIAL_BITS), size=g[tuple(face)].shape)
                g[tuple(face)] = SPECIAL_BITS[pick].view(np.float32)
    return grids


def _port_pack(grids):
    return pack_mac3_combined(*map(torch.from_numpy, grids)).numpy()


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("shape", [(12, 8, 16), (16, 16, 16)])
def test_pack_bit_equal_to_jax(shape, pallas):
    """Bit-equal to JAX's XLA pack and to its Pallas kernel (interpret)."""
    grids = _grids(shape, seed=sum(shape))
    jax_fn = jax_pack_pallas if pallas else jax_pack
    want = np.asarray(jax_fn(*map(jnp.asarray, grids)))
    got = _port_pack(grids)
    nx, ny, nz = shape
    assert got.shape == (nx * ny * (nz - 1), 64)
    np.testing.assert_array_equal(got, want)


def test_pack_bit_equal_to_xla_where_pallas_refuses():
    """ny = 9 breaks the Pallas kernel's ny % 8 rule; the port takes any
    shape, as the XLA pack does."""
    grids = _grids((13, 9, 17), seed=4)
    np.testing.assert_array_equal(_port_pack(grids), np.asarray(jax_pack(*map(jnp.asarray, grids))))


@pytest.mark.parametrize("shape", [(12, 8, 16), (13, 9, 17), (1, 1, 2)])
def test_pack_keeps_special_bits_as_jax(shape):
    """NaN payloads, +-inf and -0.0 next to the halo: the plain pack equals
    JAX's XLA pack bit for bit (int32 views, so its +0.0 halo too), and the
    13 last lanes are +0.0."""
    grids = _special_grids(shape, seed=7 + sum(shape))
    want = np.asarray(jax_pack(*map(jnp.asarray, grids)))
    got = _port_pack(grids)
    assert np.isnan(got).any() and np.isinf(got).any() and np.signbit(got[got == 0]).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert not got[:, len(cuda_pack.LANES):].view(np.int32).any()


def test_kernel_lane_table_matches_plain_order():
    """csrc/pack.cu's lane decode is LANES in order, then 13 zero lanes."""
    src = (ROOT / "fluidsimulation_tpu_torch" / "csrc" / "pack.cu").read_text()
    body = re.search(r"kLanes\[kRow\] = \{(.*?)\n\};", src, re.S).group(1)
    entries = [tuple(map(int, e)) for e in re.findall(r"\{(\d), (\d), (\d), (\d)\}", body)]
    assert entries == [*cuda_pack.LANES, *[(3, 0, 0, 0)] * (64 - len(cuda_pack.LANES))]


def _interior():
    rng = np.random.default_rng(1)
    n = 5000
    return [(rng.random(n) * m).astype(np.float32) for m in (NX, NY, NZ)]


def _edges():
    """Clamp quirks: below 0, above n-1, exactly integral, half-offsets."""
    vals_x = np.array([-0.7, -0.5, 0.0, 0.25, 0.5, 1.0, NX - 2.0, NX - 1.5, NX - 1.0,
                       NX - 0.5, NX - 0.2, float(NX)], np.float32)
    grid = np.meshgrid(vals_x, vals_x * NY / NX, vals_x * NZ / NX, indexing="ij")
    return [g.ravel() for g in grid]


def _integral():
    pi = np.repeat(np.arange(NX, dtype=np.float32), 4)
    pj = np.tile(np.array([0.0, 1.0, NY - 2.0, NY - 1.0], np.float32), NX)
    pk = np.linspace(0, NZ - 1, 4 * NX).astype(np.float32)
    return [pi, pj, pk]


# The point sets and grid seeds of tests/test_interp_combined.py.
POINTS = {"interior": (_interior, 0), "edges": (_edges, 3), "integral": (_integral, 5)}


@pytest.mark.parametrize("case", list(POINTS))
def test_interp_combined_matches_jax(case):
    """Bound 1e-6 abs on unit-normal grids: the two sum in other orders."""
    points, seed = POINTS[case]
    grids, q = _grids(seed=seed), points()
    jtab = jax_pack(*map(jnp.asarray, grids))
    want = jax_interp_combined(jtab, (NX, NY, NZ), *map(jnp.asarray, q))
    got = interp_mac3_combined(torch.from_numpy(_port_pack(grids)), (NX, NY, NZ),
                               *map(torch.from_numpy, q))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", list(POINTS))
def test_interp_combined_matches_pointwise(case):
    """Within 2e-6 of interp_mac3, the bound JAX holds between its pair."""
    points, seed = POINTS[case]
    grids = [torch.from_numpy(g) for g in _grids(seed=seed)]
    q = [torch.from_numpy(p) for p in points()]
    got = interp_mac3_combined(pack_mac3_combined(*grids), (NX, NY, NZ), *q)
    for g, want in zip(got, interp_mac3(*grids, *q)):
        torch.testing.assert_close(g, want, rtol=0, atol=2e-6)


def test_rk3_through_table_matches_advect():
    """RK3 stages 2-3 through the table, stage 1 from the carried k1, on a
    16^3 state after 3 steps: within 1e-6 m of advect_rk3_cached."""
    n, dt = 16, 1.0 / 60.0
    cfg = ft.SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n), particles_per_cell_axis=1)
    s = ft.init_state(cfg, "cpu")
    for _ in range(3):
        s = ft.step(s, dt, cfg)
    assert float(s.k1.abs().max()) > 0.1
    tab = pack_mac3_combined(s.u, s.v, s.w)
    stages = []

    def through_table(label, orig, args):
        stages.append(label)
        return interp_mac3_combined_vec(tab, (n, n, n), args[3])

    want = advect_rk3_cached(cfg, s.u, s.v, s.w, s.k1, s.pos, dt)
    with hooked([("ops.advect", "interp_mac3_vec", "interp")], through_table):
        got = advect_rk3_cached(cfg, s.u, s.v, s.w, s.k1, s.pos, dt)
    assert len(stages) == 2 and not torch.equal(got, s.pos)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_cpu_tensor_takes_plain_form():
    grids = [torch.from_numpy(g) for g in _grids()]
    before = cuda_pack.KERNEL.launches
    tab = pack_mac3_combined(*grids)
    assert cuda_pack.KERNEL.launches == before
    assert torch.equal(tab, cuda_pack.pack_mac3_combined_plain(*grids))
    with pytest.raises(ValueError, match="nz >= 2"):
        pack_mac3_combined(*[torch.from_numpy(g) for g in _grids((4, 4, 1))])
