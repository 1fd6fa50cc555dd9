"""MAC-grid trilinear interpolation with the CPU solver's semantics.

Port of fluidsimulation_tpu/core/interp.py (FluidSim3::InterpolateMACCell,
Simulation3D.h:55-123), including the top-edge index decrements of
``_split_normal`` and ``_split_extended``. Positions are in cell units.
Every lerp is a separate multiply and add, the same rounding as the G2P
kernel (csrc/g2p.cu, compiled with -fmad=false).

A NaN coordinate gives NaN, with no raise (JAX's rule: NaN in, NaN out):
the clamp keeps the NaN in the fraction, and the index's upper bound, taken
with fmin, maps it into range; no pass is added for it.
"""

from __future__ import annotations

import torch


def _lerp(a, b, t):
    return a + (b - a) * t


def _split_normal(coord, m: int):
    """Clamp to [0, m-1]; floor, but at most m-2 (Simulation3D.h:61,70).
    fmin is min for a number and maps NaN to the bound (clamp would keep
    it), so the index stays in range; the fraction keeps the NaN."""
    n = coord.clamp(0.0, m - 1.0)
    i = torch.fmin(torch.floor(n), torch.tensor(m - 2.0))
    return i.long(), n - i


def _split_extended(coord, m: int):
    """Clamp coord+0.5 to [0, m]; floor, but at most m-1 (Simulation3D.h:65,73)."""
    e = (coord + 0.5).clamp(0.0, float(m))
    i = torch.fmin(torch.floor(e), torch.tensor(m - 1.0))
    return i.long(), e - i


def _trilerp(g, i0, j0, k0, fi, fj, fk):
    _, sy, sz = g.shape
    flat = g.reshape(-1)
    base = (i0 * sy + j0) * sz + k0
    dx, dy = sy * sz, sz

    def at(off):
        return flat[base + off]

    t00 = _lerp(at(0), at(dx), fi)
    t10 = _lerp(at(dy), at(dx + dy), fi)
    t01 = _lerp(at(1), at(dx + 1), fi)
    t11 = _lerp(at(dy + 1), at(dx + dy + 1), fi)
    tx0 = _lerp(t00, t10, fj)
    tx1 = _lerp(t01, t11, fj)
    return _lerp(tx0, tx1, fk)


def interp_mac3(u, v, w, pi, pj, pk):
    """Interpolate the (u, v, w) MAC grids at cell-unit positions.

    u: (nx+1, ny, nz); v: (nx, ny+1, nz); w: (nx, ny, nz+1).
    Returns (uval, vval, wval), each shaped like pi.
    """
    nx = u.shape[0] - 1
    ny = v.shape[1] - 1
    nz = w.shape[2] - 1
    iI, fI = _split_normal(pi, nx)
    iJ, fJ = _split_normal(pj, ny)
    iK, fK = _split_normal(pk, nz)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    iEK, fEK = _split_extended(pk, nz)
    uval = _trilerp(u, iEI, iJ, iK, fEI, fJ, fK)
    vval = _trilerp(v, iI, iEJ, iK, fI, fEJ, fK)
    wval = _trilerp(w, iI, iJ, iEK, fI, fJ, fEK)
    return uval, vval, wval


def interp_mac3_vec(u, v, w, pos_cells):
    """interp_mac3 on stacked (..., 3) positions; returns (..., 3)."""
    vals = interp_mac3(u, v, w, pos_cells[..., 0], pos_cells[..., 1], pos_cells[..., 2])
    return torch.stack(vals, dim=-1)
