"""Combined-key MAC interpolation: one 256 B row gather a query.

Port of fluidsimulation_tpu/core/interp_combined.py. The grids are packed
once into a table of (nx*ny*(nz-1), 64) float32 rows (533 MB at 128^3,
66 MB at 64^3; ``pack_mac3_combined``, a CUDA kernel on the card), keyed by
the query's x/y extended and z normal indices:

  U block: x in {iEI, iEI+1} (2) x y in {iEJ-1..iEJ+1} (3) x z in {iK, iK+1} (2) = 12 lanes
  V block: x (3) x y in {iEJ, iEJ+1} (2) x z (2)                                 = 12 lanes
  W block: x (3) x y (3) x z-faces {iK..iK+2} (3)                                = 27 lanes

Each block over-fetches one row along its hat-reduced axes; the hat weight
max(0, 1-|coord - lane_pos|) is the reference's lerp weight on the two true
lanes and exactly zero on the over-fetched one, so the result equals
core/interp.py::interp_mac3 up to reassociation of the sums. Neither package
calls it from the step: advect interpolates pointwise (core/interp.py).
"""

from __future__ import annotations

import torch

from .cuda_pack import pack_mac3_combined

__all__ = ["pack_mac3_combined", "interp_mac3_combined", "interp_mac3_combined_vec"]


def _split_normal(coord, m: int):
    """Clamp to [0, m-1]; floor, but at most m-2. Returns (index, fraction,
    clamped coordinate), the index as a float."""
    n = coord.clamp(0.0, m - 1.0)
    i = torch.floor(n).clamp(max=m - 2.0)
    return i, n - i, n


def _split_extended(coord, m: int):
    """Clamp coord+0.5 to [0, m]; floor, but at most m-1."""
    e = (coord + 0.5).clamp(0.0, float(m))
    i = torch.floor(e).clamp(max=m - 1.0)
    return i, e - i


def interp_mac3_combined(tab, dims, pi, pj, pk):
    """Interpolate the MAC grids through their combined table.

    tab: (nx*ny*(nz-1), 64) float32 from ``pack_mac3_combined`` (533 MB at
    128^3); dims = (nx, ny, nz); pi, pj, pk: flat (N,) cell-unit
    coordinates. Returns (uval, vval, wval), each (N,)."""
    nx, ny, nz = dims
    nzk = nz - 1

    _, _, nI = _split_normal(pi, nx)
    _, _, nJ = _split_normal(pj, ny)
    iK, fK, _ = _split_normal(pk, nz)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    iEK, fEK = _split_extended(pk, nz)

    key = (iEI.long() * ny + iEJ.long()) * nzk + iK.long()
    rows = tab[key]  # (N, 64)

    # Hat weights: on the two true lanes of each axis they equal the
    # reference lerp weights (1-f, f); on the over-fetched lane they are 0.
    d3 = torch.arange(3, dtype=torch.float32, device=pi.device)
    wxe = torch.stack([1.0 - fEI, fEI], dim=-1)  # (N, 2)
    wye = torch.stack([1.0 - fEJ, fEJ], dim=-1)
    wze = torch.stack([1.0 - fK, fK], dim=-1)
    wxn = (1.0 - (nI[:, None] - (iEI[:, None] - 1.0 + d3)).abs()).clamp(min=0.0)
    wyn = (1.0 - (nJ[:, None] - (iEJ[:, None] - 1.0 + d3)).abs()).clamp(min=0.0)
    eK = iEK + fEK
    wzw = (1.0 - (eK[:, None] - (iK[:, None] + d3)).abs()).clamp(min=0.0)

    wu = (wxe[:, :, None, None] * wyn[:, None, :, None] * wze[:, None, None, :]).reshape(-1, 12)
    wv = (wxn[:, :, None, None] * wye[:, None, :, None] * wze[:, None, None, :]).reshape(-1, 12)
    ww = (wxn[:, :, None, None] * wyn[:, None, :, None] * wzw[:, None, None, :]).reshape(-1, 27)

    uval = (rows[:, 0:12] * wu).sum(-1)
    vval = (rows[:, 12:24] * wv).sum(-1)
    wval = (rows[:, 24:51] * ww).sum(-1)
    return uval, vval, wval


def interp_mac3_combined_vec(tab, dims, pos_cells):
    """interp_mac3_combined on stacked (..., 3) cell-unit positions, through
    the (nx*ny*(nz-1), 64) float32 table (533 MB at 128^3); returns (..., 3)."""
    shape = pos_cells.shape[:-1]
    flat = pos_cells.reshape(-1, 3)
    vals = interp_mac3_combined(tab, dims, flat[:, 0], flat[:, 1], flat[:, 2])
    return torch.stack(vals, dim=-1).reshape(*shape, 3)
