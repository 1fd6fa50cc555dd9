"""The APIC P2G kernel (ops/cuda_p2g_apic.py, csrc/p2g_apic.cu) against the
plain form it stands in for on the card (ops/apic.py::p2g_apic_cells).

The kernel forms each term as the plain form does and sums each face's
terms in CSR order (the particles sorted by cell, stably), where the plain
form sums node by node. ``_csr_order`` is the plain form with that one
change: its 27 nodes concatenated particle by particle into one
``index_add_`` over the CSR-sorted particles, which on the CPU adds in index
order. Where no cell is dense, so that each lane of the kernel walks its own
runs (none of 64 particles or more), it is the kernel's answer, bit for bit
(where a warp shares a dense cell's run out in pieces, the pieces' sums are
added in order instead).
Against the plain form the order moves a face only by rounding, which the
CPU tests here bound:
``|a - b| <= ORDER_RTOL * (|b| + rms)``, rms the grid's root mean square
(a face sums at most 27 x 8 terms at two particles a cell axis, each term
of these inputs up to ~20 in size, so reordering moves a mean by some
1e-6 of the grid's scale), and validity equal except where the weight lies
within 1e-6 of the threshold.

On the CPU (no card needed): p2g_apic keeps the plain form's bits, which are
JAX's (tests/test_torch_apic.py), and never launches the kernel; the CSR
order's sums lie within the bound of the plain form's.

Marked ``cuda`` (skipped without a card; ``python -m pytest
tests/test_torch_apic_kernel.py -m cuda -q``): random positions, velocities
and affine rows at 16^3 and 32^3 with one and two particles a cell axis and
on a 24 x 16 x 40 grid (ragged tiles, a grid whose m is not a power of two,
so the kernel divides), against the plain form within the bound and
against ``_csr_order`` bit for bit; a pile of 4,500 particles in one wall
cell (a halo walked in many chunks, the pile's run shared out in pieces),
within the bound and the same bits from two launches; one NaN coordinate,
which leaves the
plain form's faces non-finite and no others; two launches bit-equal; one
launch per ``step_apic`` on the card; and the half batch of
bench_torch/harness/faults.py (every other particle), the plain form's
answer on that half.
"""

import math

import numpy as np
import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import cuda_p2g_apic
from fluidsimulation_tpu_torch.ops.apic import (
    APIC_WEIGHT_THRESH,
    _component_nodes,
    _shapes,
    p2g_apic,
    p2g_apic_cells,
)
from fluidsimulation_tpu_torch.ops.binning import build_csr_cells
from fluidsimulation_tpu_torch.ops.common import cell_scale

ORDER_RTOL = 1e-5
NAMES = ("u", "v", "w", "uv", "vv", "wv")
BAD = 5  # the particle that gets a NaN coordinate


@pytest.fixture(autouse=True)
def one_thread():
    # The CPU's index_add_ adds in index order on one thread.
    torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _cfg(shape, ppc=1):
    nx, ny, nz = shape
    return ft.SimConfig(nx=nx, ny=ny, nz=nz, cells_per_meter=float(nx),
                        particles_per_cell_axis=ppc)


def _inputs(cfg, per_cell, seed, pile=0):
    """per_cell * nx*ny*nz positions uniform over the advection clamp box
    (ops/advect.py), ``pile`` more in the wall cell (0, ny/2, nz/2), normal
    velocities and C of scale 5 (1/s), on the CPU."""
    rng = np.random.default_rng(seed)
    m = np.array([cfg.nx, cfg.ny, cfg.nz], dtype=np.float32)
    n = per_cell * cfg.nx * cfg.ny * cfg.nz
    pos = rng.uniform(-0.4 / m, 1.0 - 0.6 / m, size=(n, 3))
    if pile:
        cell = np.array([0.0, cfg.ny // 2, cfg.nz // 2])
        lo = np.array([-0.4, -0.45, -0.45])
        pos = np.concatenate([pos, (cell + rng.uniform(lo, 0.45, size=(pile, 3))) / m])
    n = pos.shape[0]
    vel = rng.standard_normal((n, 3))
    C = 5.0 * rng.standard_normal((n, 3, 3))
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (pos, vel, C))


def _plain(cfg, pos, vel, C):
    m = cell_scale(cfg, pos.device)
    return p2g_apic_cells(cfg, pos * m, vel, C, m)


def _csr_order(cfg, pos, vel, C):
    """The plain form with each face's terms summed in CSR order (see the
    module docstring); on the CPU."""
    m = cell_scale(cfg, pos.device)
    pc = pos * m
    csr = build_csr_cells(cfg, pc)
    pcs, vels, cs = pc[csr.order], vel[csr.order], C[csr.order]
    out = []
    for comp_axis, shape in _shapes(cfg):
        _, sy, sz = shape
        lin, wgt, val = [], [], []
        for idx, ok, w, dxm in _component_nodes(cfg, pcs, comp_axis, m):
            crow = cs[:, comp_axis, :]
            val.append(vels[:, comp_axis] + crow[:, 0] * dxm[0] + crow[:, 1] * dxm[1]
                       + crow[:, 2] * dxm[2])
            lin.append(torch.where(ok, (idx[0] * sy + idx[1]) * sz + idx[2], 0))
            wgt.append(torch.where(ok, w, 0.0))
        lin, wgt, val = (torch.stack(a, 1).reshape(-1) for a in (lin, wgt, val))
        acc = torch.zeros(math.prod(shape), dtype=torch.float32).index_add_(0, lin, wgt * val)
        amt = torch.zeros_like(acc).index_add_(0, lin, wgt)
        g = (acc / amt.clamp(min=1e-30)).reshape(shape)
        valid = (amt > APIC_WEIGHT_THRESH).reshape(shape)
        for end in (0, -1):
            g.select(comp_axis, end).zero_()
            valid.select(comp_axis, end).fill_(True)
        out.append((g, valid))
    (u, uv), (v, vv), (w, wv) = out
    return u, v, w, uv, vv, wv


def _plain_amounts(cfg, pos):
    """Each face's weight sum, the plain form's amt (for the threshold
    test)."""
    m = cell_scale(cfg, pos.device)
    out = []
    for comp_axis, shape in _shapes(cfg):
        _, sy, sz = shape
        amt = torch.zeros(math.prod(shape), dtype=torch.float32)
        for idx, ok, w, _ in _component_nodes(cfg, pos * m, comp_axis, m):
            amt.index_add_(0, torch.where(ok, (idx[0] * sy + idx[1]) * sz + idx[2], 0),
                           torch.where(ok, w, 0.0))
        out.append(amt.reshape(shape))
    return out


def _within_order_bound(cfg, pos, got, want):
    """Validity equal but within 1e-6 of the threshold; finite faces valid
    in both within ORDER_RTOL * (|b| + rms); the same faces non-finite."""
    for name, g, b, amt in zip(NAMES[:3], got[:3], want[:3], _plain_amounts(cfg, pos)):
        gv, bv = got[NAMES.index(name) + 3], want[NAMES.index(name) + 3]
        near = (amt - APIC_WEIGHT_THRESH).abs() < 1e-6
        assert not bool(((gv != bv) & ~near).any()), name
        assert torch.equal(g.isfinite(), b.isfinite()), name
        fin = b.isfinite() & gv & bv
        rms = float(b[fin].square().mean().sqrt())
        err = (g - b).abs()[fin]
        assert bool((err <= ORDER_RTOL * (b.abs()[fin] + rms)).all()), (
            f"{name}: {float(err.max())} against rms {rms}")


def _same(a, b):
    """Equal values and the same non-finite places (NaN bits may differ)."""
    return all(torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0))
               for x, y in zip(a, b))


CASES = {
    "16-ppc1": ((16, 16, 16), 1, 1),
    "16-ppc2": ((16, 16, 16), 8, 2),
    "32-ppc1": ((32, 32, 32), 1, 3),
    "32-ppc2": ((32, 32, 32), 8, 4),
    "24x16x40": ((24, 16, 40), 4, 5),
}


def test_p2g_apic_on_cpu_is_the_plain_form():
    """A CPU tensor takes the plain form, bit for bit (the path held to
    JAX's), and launches nothing."""
    cfg = _cfg((16, 16, 16), 2)
    pos, vel, C = _inputs(cfg, 8, 7)
    before = cuda_p2g_apic.KERNEL.launches
    got = p2g_apic(cfg, pos, vel, C)
    assert cuda_p2g_apic.KERNEL.launches == before
    for name, g, w in zip(NAMES, got, _plain(cfg, pos, vel, C)):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("case", ["16-ppc2", "24x16x40"])
def test_csr_order_within_the_bound_of_the_plain_form(case):
    """The kernel's order of summation moves no face past ORDER_RTOL, and
    no validity but at the threshold."""
    shape, per_cell, seed = CASES[case]
    cfg = _cfg(shape)
    pos, vel, C = _inputs(cfg, per_cell, seed)
    got = _csr_order(cfg, pos, vel, C)
    _within_order_bound(cfg, pos, got, _plain(cfg, pos, vel, C))


def _on_card(cfg, dev, pos, vel, C):
    before = cuda_p2g_apic.KERNEL.launches
    out = p2g_apic(cfg, pos.to(dev), vel.to(dev), C.to(dev))
    torch.cuda.synchronize()
    assert cuda_p2g_apic.KERNEL.launches - before == 1
    return [t.cpu() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(dev, case):
    shape, per_cell, seed = CASES[case]
    cfg = _cfg(shape)
    pos, vel, C = _inputs(cfg, per_cell, seed)
    got = _on_card(cfg, dev, pos, vel, C)
    _within_order_bound(cfg, pos, got, _plain(cfg, pos, vel, C))
    want = _csr_order(cfg, pos, vel, C)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
def test_kernel_pile_at_the_wall(dev):
    """4,500 particles in one wall cell: the halos around it are walked in
    chunks of 640 positions, and the warps next to the pile share its runs
    out in pieces."""
    cfg = _cfg((24, 16, 40))
    pos, vel, C = _inputs(cfg, 2, 11, pile=4500)
    got = _on_card(cfg, dev, pos, vel, C)
    _within_order_bound(cfg, pos, got, _plain(cfg, pos, vel, C))
    assert all(torch.equal(g, w) for g, w in zip(got, _on_card(cfg, dev, pos, vel, C)))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_kernel_nan_coordinate(dev, axis):
    """One particle with a NaN coordinate (kept past start[ncell] by the
    index): the same faces non-finite as the plain form, the rest within
    the bound."""
    cfg = _cfg((16, 16, 16))
    pos, vel, C = _inputs(cfg, 2, 13)
    pos[BAD, axis] = float("nan")
    got = _on_card(cfg, dev, pos, vel, C)
    want = _plain(cfg, pos, vel, C)
    assert any(not bool(g.isfinite().all()) for g in want[:3])
    _within_order_bound(cfg, pos, got, want)
    assert _same(got, _csr_order(cfg, pos, vel, C))


@pytest.mark.cuda
def test_kernel_deterministic(dev):
    cfg = _cfg((32, 32, 32))
    pos, vel, C = (t.to(dev) for t in _inputs(cfg, 8, 17))
    a = p2g_apic(cfg, pos, vel, C)
    b = p2g_apic(cfg, pos, vel, C)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_step_apic_launches_the_kernel_once(dev):
    cfg = _cfg((32, 32, 32))
    s = ft.step_apic(ft.init_apic_state(cfg, dev), 1.0 / 60.0, cfg)
    before = cuda_p2g_apic.KERNEL.launches
    ft.step_apic(s, 1.0 / 60.0, cfg)
    torch.cuda.synchronize()
    assert cuda_p2g_apic.KERNEL.launches - before == 1


@pytest.mark.cuda
def test_kernel_half_batch(dev):
    """Every other particle, as views (the benchmark's half-batch fault):
    the plain form's answer on that half."""
    cfg = _cfg((16, 16, 16))
    pos, vel, C = _inputs(cfg, 8, 19)
    d = [t.to(dev) for t in (pos, vel, C)]
    got = [t.cpu() for t in p2g_apic(cfg, d[0][::2], d[1][::2], d[2][::2])]
    half = (pos[::2], vel[::2].contiguous(), C[::2].contiguous())
    _within_order_bound(cfg, half[0], got, _plain(cfg, *half))
    assert all(torch.equal(g, w) for g, w in zip(got, _csr_order(cfg, *half)))
