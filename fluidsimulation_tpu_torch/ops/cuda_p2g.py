"""P2G accumulators: the CUDA gather over the CSR index (csrc/p2g.cu, cell
tiles with their particles staged through shared memory a halo plane at a
time; each face walks its short runs itself, and the long runs of dense
cells and piles are cut into pieces that the whole block shares) and its
plain PyTorch version, the scatter form of ops/p2g.py.

Replaces fluidsimulation_tpu/ops/pallas_p2g_super.py::
p2g_accumulate_pallas_super. Both return, for U, V and W in turn, the pair
(acc, amt): sum of w*vel and sum of w on the staggered grid. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel. The kernel sums
each face's particles in an order fixed by its own window in CSR order, so
its bits depend on that window alone; they differ from the scatter form's
by summation order only. While a recording of utils/trace.py is open, a launch
adds to the step's device counters p2g.visits (particle visits walked) and
p2g.lane_steps (the lane-steps the blocks spent on them).
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.config import SimConfig
from ..utils import trace

KERNEL = _build.Kernel(
    "fst_p2g",
    [_build.P] * 9 + [_build.I] * 4 + [_build.P],
)
COUNTERS = ("p2g.visits", "p2g.lane_steps")  # the kernel's device counters, in its order


def face_shapes(cfg: SimConfig):
    return (cfg.u_shape(), cfg.v_shape(), cfg.w_shape())


def _scatter_component(cfg: SimConfig, p, pv, comp_axis: int, shape, x0: int = 0):
    """Scatter one component to its staggered grid: each particle adds hat
    weights to 8 faces (Simulation3D.cpp:440-537). A face off the grid is
    masked, weight and value; so is every face of a particle whose position
    is not finite (its NaN index fails the range test), NaN velocity and
    all. x0 as p2g_accumulate_plain's."""
    n = p.shape[0]
    dims = (cfg.nx, cfg.ny, cfg.nz)
    base, alpha = [], []
    for ax in range(3):
        c = p[:, ax] + (0.5 if ax == comp_axis else 0.0)
        b = torch.floor(c)
        base.append(b.long() - (x0 if ax == 0 else 0))
        alpha.append(c - b)
    flat_idx, flat_w, flat_v = [], [], []
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                offs = (ox, oy, oz)
                idx = [base[ax] + offs[ax] for ax in range(3)]
                ok = torch.ones(n, dtype=torch.bool, device=p.device)
                for ax in range(3):
                    hi = dims[ax] + (1 if ax == comp_axis else 0)
                    ok = ok & (idx[ax] >= 0) & (idx[ax] < hi)
                w = torch.ones(n, dtype=torch.float32, device=p.device)
                for ax in range(3):
                    a = alpha[ax]
                    w = w * (a if offs[ax] > 0 else 1.0 - a)
                lin = (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]
                flat_idx.append(torch.where(ok, lin, 0))
                flat_w.append(torch.where(ok, w, 0.0))
                flat_v.append(torch.where(ok, w * pv, 0.0))
    lin = torch.cat(flat_idx)
    w = torch.cat(flat_w)
    vals = torch.cat(flat_v)
    ncells = shape[0] * shape[1] * shape[2]
    acc = torch.zeros(ncells, dtype=torch.float32, device=p.device).index_add_(0, lin, vals)
    amt = torch.zeros(ncells, dtype=torch.float32, device=p.device).index_add_(0, lin, w)
    return acc.reshape(shape), amt.reshape(shape)


def p2g_accumulate_plain(cfg: SimConfig, pc, vel, x0: int = 0):
    """pc: (N, 3) positions in cell units; vel: (N, 3). Any particle order.
    x0: cfg's grid is the x-slab from the domain's plane x0 on, and pc is in
    the domain's cell units (parallel/halo_step.py); 0 for a whole grid."""
    return [
        _scatter_component(cfg, pc, vel[:, a].contiguous(), a, shape, x0)
        for a, shape in enumerate(face_shapes(cfg))
    ]


def p2g_accumulate(cfg: SimConfig, pcs, vels, start, x0: int = 0):
    """pcs, vels: (N, 3) positions in cell units and velocities in CSR
    order; start: (nx*ny*nz + 1,) int32 CSR offsets (ops/binning.py); slots
    from start[-1] on (non-finite positions) are not read.

    pcs must be ``(pos * cell_scale(cfg))[csr.order]``, the very floats
    that build_csr binned: the kernel takes each particle's x and y hats
    from the cell its CSR run says, which holds only if floor(p + 0.5) of
    these floats is that cell. Positions scaled another way give wrong
    weights, with no error. x0 as p2g_accumulate_plain's: the runs are then
    the cells floor(p + 0.5) - x0 along x."""
    if pcs.device.type == "cpu":
        return p2g_accumulate_plain(cfg, pcs, vels, x0)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    n = pcs.shape[0]
    dev = _build.same_device(pcs, vels, start)
    args = [
        _build.check(pcs, "pcs", (n, 3)),
        _build.check(vels, "vels", (n, 3)),
        _build.check(start, "start", (nx * ny * nz + 1,), torch.int32),
    ]
    out = []
    for shape in face_shapes(cfg):
        acc = torch.empty(shape, dtype=torch.float32, device=dev)
        amt = torch.empty(shape, dtype=torch.float32, device=dev)
        out.append((acc, amt))
        args += [acc.data_ptr(), amt.data_ptr()]
    counts = trace.device_counts(COUNTERS, dev)
    KERNEL.launch(dev, *args, nx, ny, nz, x0, None if counts is None else counts.data_ptr())
    return out
