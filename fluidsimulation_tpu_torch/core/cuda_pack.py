"""Combined-key MAC pack: the CUDA kernel (csrc/pack.cu) and its plain
PyTorch version.

Replaces fluidsimulation_tpu/core/pallas_pack.py::pack_mac3_combined_pallas,
the TPU form of core/interp_combined.py::pack_mac3_combined. Both forms build
the (nx*ny*(nz-1), 64) float32 row table that
core/interp_combined.py::interp_mac3_combined gathers from, 533 MB at 128^3:
51 lanes of shifted grid values in the JAX column order, then 13 zero lanes.
The table is pure copies, so the kernel equals the plain version bit for
bit. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel, one launch a pack.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

KERNEL = _build.Kernel("fst_pack_mac3_combined", [_build.P] * 4 + [_build.I] * 3)

ROW = 64  # lanes a row: 256 B
# The data lanes of a row, (grid, dx, dy, dz) with grid 0/1/2 = U/V/W, in the
# JAX column order (dz fastest); dx, dy, dz are offsets into the zero-padded
# grids of ``shifted_views``.
LANES = (
    [(0, dx, dy, dz) for dx in range(2) for dy in range(3) for dz in range(2)]
    + [(1, dx, dy, dz) for dx in range(3) for dy in range(2) for dz in range(2)]
    + [(2, dx, dy, dz) for dx in range(3) for dy in range(3) for dz in range(3)]
)


def grid_dims(u, v, w) -> tuple[int, int, int]:
    """(nx, ny, nz) of the MAC grids u (nx+1, ny, nz), v (nx, ny+1, nz),
    w (nx, ny, nz+1); the table needs nx, ny >= 1 and nz >= 2."""
    if not u.dim() == v.dim() == w.dim() == 3:
        raise ValueError("u, v, w: expected 3-D MAC grids")
    nx, ny, nz = u.shape[0] - 1, v.shape[1] - 1, w.shape[2] - 1
    if nx < 1 or ny < 1 or nz < 2:
        raise ValueError(f"the combined pack needs nx, ny >= 1 and nz >= 2, got {(nx, ny, nz)}")
    return nx, ny, nz


def shifted_views(u, v, w) -> list:
    """The 51 data lanes as (nx, ny, nz-1) views of the zero-padded grids:
    U padded by one in y, V in x, W in x and y (the JAX pack's halos, where
    the hat weights are 0)."""
    nx, ny, nz = grid_dims(u, v, w)
    padded = (F.pad(u, (0, 0, 1, 1)), F.pad(v, (0, 0, 0, 0, 1, 1)), F.pad(w, (0, 0, 1, 1, 1, 1)))
    return [padded[g][dx:dx + nx, dy:dy + ny, dz:dz + nz - 1] for g, dx, dy, dz in LANES]


def pack_mac3_combined_plain(u, v, w):
    """The table (nx*ny*(nz-1), 64) float32 (533 MB at 128^3) in PyTorch:
    the 51 shifted views stacked on a last axis, 13 zero lanes, one row a
    (x, y, z) key."""
    nx, ny, nz = grid_dims(u, v, w)
    tab = torch.stack(shifted_views(u, v, w), dim=-1)
    return F.pad(tab, (0, ROW - len(LANES))).reshape(nx * ny * (nz - 1), ROW)


def pack_mac3_combined(u, v, w):
    """Build the combined row table from MAC grids.

    u: (nx+1, ny, nz); v: (nx, ny+1, nz); w: (nx, ny, nz+1), float32.
    Returns tab: (nx*ny*(nz-1), 64) float32, 533 MB at 128^3."""
    if u.device.type == "cpu":
        return pack_mac3_combined_plain(u, v, w)
    nx, ny, nz = grid_dims(u, v, w)
    dev = _build.same_device(u, v, w)
    args = [
        _build.check(g, name, shape)
        for g, name, shape in (
            (u, "u", (nx + 1, ny, nz)), (v, "v", (nx, ny + 1, nz)), (w, "w", (nx, ny, nz + 1)),
        )
    ]
    tab = torch.empty((nx * ny * (nz - 1), ROW), dtype=torch.float32, device=dev)
    KERNEL.launch(dev, *args, tab.data_ptr(), nx, ny, nz)
    return tab
