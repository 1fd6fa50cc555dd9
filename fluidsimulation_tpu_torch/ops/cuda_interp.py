"""The RK3 advection's grid gather: the CUDA kernel (csrc/interp.cu) and its
plain PyTorch version, core/interp.py::interp_mac3_vec.

ops/advect.py imports ``interp_mac3_vec`` from here under the same name and
calls it once an RK3 stage it gathers, inside that stage's ``gather`` span.
The arguments are checked on either device; then a CPU tensor takes the
plain version and a CUDA tensor launches the kernel, one launch a call, or
raises. The kernel equals the plain version bit for bit (both lerp in the
same order; the kernel is built with -fmad=false).
"""

from __future__ import annotations

import torch

from .. import _build
from ..core import interp

KERNEL = _build.Kernel("fst_interp_mac3", [_build.P] * 5 + [_build.L, _build.I, _build.I, _build.I])


def _checked(u, v, w, pos_cells) -> tuple[int, int, int, int]:
    """(n, nx, ny, nz) of the call; raises on what the kernel does not take:
    another dtype than float32, a non-contiguous tensor, positions not
    (N, 3), grids that are not the MAC grids of nx x ny x nz cells (each
    axis at least 2), tensors on different devices."""
    _build.same_device(pos_cells, u, v, w)
    if pos_cells.dim() != 2 or pos_cells.shape[1] != 3:
        raise ValueError(f"pos_cells: expected shape (N, 3), got {tuple(pos_cells.shape)}")
    if u.dim() != 3 or v.dim() != 3 or w.dim() != 3:
        raise ValueError("u, v, w: expected 3D grids")
    nx, ny, nz = u.shape[0] - 1, v.shape[1] - 1, w.shape[2] - 1
    if min(nx, ny, nz) < 2:
        raise ValueError(f"grids of {nx}x{ny}x{nz} cells: each axis needs at least 2")
    shapes = {"pos_cells": (pos_cells.shape[0], 3), "u": (nx + 1, ny, nz),
              "v": (nx, ny + 1, nz), "w": (nx, ny, nz + 1)}
    for name, t in zip(shapes, (pos_cells, u, v, w)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    return pos_cells.shape[0], nx, ny, nz


def interp_mac3_vec(u, v, w, pos_cells):
    """(u, v, w) interpolated at pos_cells, (N, 3) float32 positions in cell
    units; returns (N, 3). u: (nx+1, ny, nz), v: (nx, ny+1, nz), w: (nx, ny,
    nz+1), the sizes read off the grids as core/interp.py::interp_mac3 reads
    them, so a slab's grids are taken as they come."""
    n, nx, ny, nz = _checked(u, v, w, pos_cells)
    if pos_cells.device.type == "cpu":
        return interp.interp_mac3_vec(u, v, w, pos_cells)
    out = torch.empty((n, 3), dtype=torch.float32, device=pos_cells.device)
    KERNEL.launch(pos_cells.device, pos_cells.data_ptr(), u.data_ptr(), v.data_ptr(),
                  w.data_ptr(), out.data_ptr(), n, nx, ny, nz)
    return out
