"""Shared grid helpers for the 3D op set."""

from __future__ import annotations

import torch


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


def cell_of(pos_cells):
    """Cell index of a particle, floor(p + 0.5) (gpCountParticles.hlsl:22).

    Advection clamps positions into the domain, so no bounds check is needed.
    """
    return torch.floor(pos_cells + 0.5).long()


def cell_scale(cfg, device) -> torch.Tensor:
    """The (3,) float32 tensor [nx, ny, nz]: meters times it are cell units."""
    return torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.float32, device=device)
