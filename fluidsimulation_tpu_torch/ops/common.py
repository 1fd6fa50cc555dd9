"""Shared grid helpers for the 3D and 2D op sets."""

from __future__ import annotations

import torch

from ..utils.trace import sync


def shift(a, axis: int, s: int, fill):
    """result[i] = a[i + s] along ``axis``; out-of-range entries are ``fill``.

    With fill=0 this is HLSL's out-of-bounds read (reads return 0), which
    several reference kernels rely on (gpProjectComputeDiagCoeffs.hlsl:36-45).
    """
    if s == 0:
        return a
    out = torch.full_like(a, fill)
    n = a.shape[axis]
    if s > 0:
        out.narrow(axis, 0, n - s).copy_(a.narrow(axis, s, n - s))
    else:
        out.narrow(axis, -s, n + s).copy_(a.narrow(axis, 0, n + s))
    return out


def shift_with_halo(a, lo, hi, s: int):
    """result[x] = a[x + s] along axis 0 (s = +-1), an x-slab's neighbour
    planes ``lo`` (before x = 0) and ``hi`` (after the last x) filling the
    end: shift's form for a slab of the grid (parallel/)."""
    if s > 0:
        return torch.cat([a[1:], hi[None]], 0)
    return torch.cat([lo[None], a[:-1]], 0)


# Index of an infinite coordinate (index_of): outside every grid, and the
# indices of its neighbouring nodes stay far from overflow.
FAR_INDEX = float(2**30)


def index_of(c):
    """Floored float coordinates c as int64 indices, NaN as JAX's
    float-to-int conversion gives it (0), +-inf as +-FAR_INDEX. A NaN
    particle then takes in-range nodes whose weights carry its NaN, as in
    JAX; torch's own cast would give -2^63."""
    return torch.nan_to_num(c, nan=0.0, posinf=FAR_INDEX, neginf=-FAR_INDEX).long()


def far_cell(cfg) -> float:
    """Cell index given to a non-finite coordinate: the least power of two
    at or above ncell = nx*ny*nz, exact in float32. build_csr's linear id
    (cx*ny + cy)*nz + cz of a particle with any such coordinate is then at
    least ncell (finite cells are >= 0), so it sorts after every cell. The
    id stays below 2^63 for any grid whose CSR offsets fit in memory."""
    ncell = cfg.nx * cfg.ny * cfg.nz
    return float(1 << (ncell - 1).bit_length())


def cell_of(pos_cells, far: float):
    """Cell index of a particle, floor(p + 0.5) (gpCountParticles.hlsl:22).

    Advection clamps finite positions into the domain, so no bounds check is
    needed. A non-finite coordinate (NaN survives the clamp) gets ``far``
    (far_cell), which keeps its conversion to an integer defined.
    """
    c = torch.floor(pos_cells + 0.5)
    return torch.nan_to_num(c, nan=far, posinf=far, neginf=far).long()


def cell_scale(cfg, device) -> torch.Tensor:
    """The (3,) float32 tensor [nx, ny, nz]: meters times it are cell units.
    On the card a copy from pageable host memory, after which torch waits
    for the stream: a sync."""
    with sync():
        return torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.float32, device=device)
