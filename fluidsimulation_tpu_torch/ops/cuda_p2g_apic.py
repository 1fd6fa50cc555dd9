"""APIC P2G on the card: the CUDA gather over a CSR index of the particles
(csrc/p2g_apic.cu), in place of the plain form's 162 ``index_add_``
scatters (ops/apic.py::p2g_apic_cells, which the CPU keeps).

The JAX package has no Pallas kernel for this transfer, so the kernel
replaces none. It builds the CSR index of the particles it is given
(ops/binning.py::build_csr_cells), so it takes them in any order and any
subset, gathers their positions, velocities and affine rows into that
order, and launches once. Its faces differ from the plain form's only by
the order of each face's sum (column, run, slot); they are the same bits on
every run.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.config import SimConfig
from .binning import build_csr_cells

KERNEL = _build.Kernel(
    "fst_p2g_apic",
    [_build.P] * 4 + [_build.I] + [_build.P] * 6 + [_build.I] * 3 + [_build.F],
)


def p2g_apic_gather(cfg: SimConfig, pc, vel, C, thresh: float):
    """pc: (N, 3) positions in cell units, pos * cell_scale(cfg), each
    finite one inside the grid's cells; vel (N, 3); C (N, 3, 3); any order.
    Returns (u, v, w, uv, vv, wv) as ops/apic.py::p2g_apic_cells does: the
    face means and their validity (weight above ``thresh``), boundary faces
    0 and valid. CUDA tensors only."""
    n = pc.shape[0]
    _build.same_device(pc, vel, C)
    if tuple(vel.shape) != (n, 3) or tuple(C.shape) != (n, 3, 3):
        raise ValueError(f"vel {tuple(vel.shape)} and C {tuple(C.shape)} do not match pc's {n} rows")
    csr = build_csr_cells(cfg, pc)
    order, start = csr.order, csr.start
    del csr  # its cells, N int64, are not read
    return p2g_apic_sorted(cfg, pc[order], vel[order], C.reshape(n, 9)[order], start, thresh)


def p2g_apic_sorted(cfg: SimConfig, pcs, vels, cs, start, thresh: float):
    """The launch: pcs (N, 3), vels (N, 3) and cs (N, 9) in the CSR order
    whose offsets are start ((nx*ny*nz + 1,) int32); pcs must be the very
    floats the index was built from. Slots from start[-1] on (non-finite
    positions) are read too."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    n = pcs.shape[0]
    dev = _build.same_device(pcs, vels, cs, start)
    args = [
        _build.check(pcs, "pcs", (n, 3)),
        _build.check(vels, "vels", (n, 3)),
        _build.check(cs, "cs", (n, 9)),
        _build.check(start, "start", (nx * ny * nz + 1,), torch.int32),
        n,
    ]
    shapes = (cfg.u_shape(), cfg.v_shape(), cfg.w_shape())
    grids = [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]
    valid = [torch.empty(s, dtype=torch.bool, device=dev) for s in shapes]
    KERNEL.launch(dev, *args, *(g.data_ptr() for g in grids + valid), nx, ny, nz, float(thresh))
    u, v, w = grids
    uv, vv, wv = valid
    return u, v, w, uv, vv, wv
