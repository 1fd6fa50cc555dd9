"""Pressure projection: RHS, ghost-fluid diagonal, checkerboard SOR and the
pressure-gradient velocity update.

Port of fluidsimulation_tpu/ops/project.py (gpProjectComputeRHS.hlsl,
gpProjectComputeDiagCoeffs.hlsl, gpProjectIteration{1,2}.hlsl x100 and
gpProjectToVel.hlsl). The SOR is ops/cuda_sor.py: the CUDA kernel on the
card at every grid size, its plain PyTorch version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SimConfig
from .common import shift, shift_with_halo
from .cuda_sor import sor_pressure


def compute_rhs(cfg: SimConfig, u, v, w, dt):
    """b = -dx*rho/dt * div(u) per cell."""
    scale = np.float32(-cfg.dx * cfg.rho) / np.float32(dt)
    div = (
        u[1:, :, :] - u[:-1, :, :]
        + v[:, 1:, :] - v[:, :-1, :]
        + w[:, :, 1:] - w[:, :, :-1]
    )
    return scale * div


def _interior(n: int, axis: int, device, first: int = 0, count: int | None = None):
    """Whether each of the indices first .. first + count - 1 of an axis of n
    cells is inside the grid, not on its edge, as float32 along ``axis``."""
    i = first + torch.arange(n if count is None else count, device=device)
    shape = [1, 1, 1]
    shape[axis] = i.numel()
    return ((i > 0) & (i < n - 1)).to(torch.float32).reshape(shape)


def compute_diag(cfg: SimConfig, phi, x_halo=None, x0: int = 0):
    """Diagonal coefficients with ghost-fluid terms. Air cells get 1.0.

    ``x_halo`` = (lo, hi): phi is the x-slab of the grid from global x
    plane x0 on, and lo, hi are the (ny, nz) planes of phi just before and
    after it (0 past the domain's edge), as parallel/halo_step.py passes
    them; None: phi is the whole grid."""
    maxr = cfg.max_ls_ratio
    fluid = phi < 0.0
    dev = phi.device
    num = (
        3.0
        + _interior(cfg.nx, 0, dev, x0, phi.shape[0])
        + _interior(cfg.ny, 1, dev)
        + _interior(cfg.nz, 2, dev)
    ).expand(phi.shape)
    recip = 1.0 / torch.where(fluid, phi, -1.0)  # read only where fluid
    ghost = torch.zeros_like(phi)
    for axis in range(3):
        for s in (-1, 1):
            if axis == 0 and x_halo is not None:
                nb = shift_with_halo(phi, *x_halo, s)
            else:
                nb = shift(phi, axis, s, 0.0)
            ghost = ghost + torch.clamp(-nb * recip, 0.0, maxr)
    return torch.where(fluid, num + ghost, 1.0)


def face_update(cfg: SimConfig, cur, phiL, phiR, pL, pR, dt):
    """The pressure-gradient update of the faces ``cur`` between the cells
    with level set phiL, phiR and pressure pL, pR (4-case ghost fluid)."""
    maxr = cfg.max_ls_ratio
    scale = np.float32(dt) / np.float32(cfg.rho * cfg.dx)
    safeL = torch.where(phiL != 0.0, phiL, -1e-30)
    safeR = torch.where(phiR != 0.0, phiR, -1e-30)
    both = cur - scale * (pR - pL)
    lonly = cur + scale * pL * (1.0 + torch.clamp(-phiR / safeL, 0.0, maxr))
    ronly = cur - scale * pR * (1.0 + torch.clamp(-phiL / safeR, 0.0, maxr))
    return torch.where(
        phiL < 0.0,
        torch.where(phiR < 0.0, both, lonly),
        torch.where(phiR < 0.0, ronly, 0.0),
    )


def apply_pressure(cfg: SimConfig, u, v, w, p, phi, dt):
    """Pressure-gradient update with 4-case ghost-fluid handling. Domain-edge
    faces are left as they are (0 from the transfer and force stages)."""

    def update(grid, axis):
        n = phi.shape[axis]
        phiL, phiR = phi.narrow(axis, 0, n - 1), phi.narrow(axis, 1, n - 1)
        pL, pR = p.narrow(axis, 0, n - 1), p.narrow(axis, 1, n - 1)
        val = face_update(cfg, grid.narrow(axis, 1, n - 1), phiL, phiR, pL, pR, dt)
        out = grid.clone()
        out.narrow(axis, 1, n - 1).copy_(val)
        return out

    return update(u, 0), update(v, 1), update(w, 2)


def project(cfg: SimConfig, u, v, w, phi, dt):
    """Full projection (GPFluidSim::ProjectGPU, Simulation.cpp:860-943).
    Returns (u, v, w, p)."""
    b = compute_rhs(cfg, u, v, w, dt)
    diag = compute_diag(cfg, phi)
    p = sor_pressure(cfg, phi, diag, b)
    u, v, w = apply_pressure(cfg, u, v, w, p, phi, dt)
    return u, v, w, p
