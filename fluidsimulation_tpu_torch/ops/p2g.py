"""Particle-to-grid velocity transfer (trilinear hat kernel).

Port of fluidsimulation_tpu/ops/p2g.py. Two forms compute the same weighted
averages and differ only in summation order:

* ``transfer_to_grid``: the scatter form (each particle adds to 8 faces per
  component), the CPU solver's (Simulation3D.cpp:440-537) and the reference
  these tests hold the gather to;
* ``p2g_from_csr``: the gather over the CSR index, the GPU reference's own
  design (gpTransferParticleVelocities{U,V,W}.hlsl); on the card it is the
  CUDA kernel of ops/cuda_p2g.py.

Boundary (wall-normal) faces are 0 and valid (hlsl:30-33); a face whose
weight sum is at most zero_thresh is invalid (hlsl:61-64), returned as a
mask. Invalid faces hold an unspecified value; extrapolation overwrites it.
"""

from __future__ import annotations

import torch

from ..core.config import SimConfig
from .binning import CSR
from .common import cell_scale
from .cuda_p2g import p2g_accumulate, p2g_accumulate_plain


def _normalise(cfg: SimConfig, accumulators):
    """(acc, amt) for U, V, W -> (u, v, w, u_valid, v_valid, w_valid)."""
    grids, masks = [], []
    for a, (acc, amt) in enumerate(accumulators):
        g = acc / torch.clamp(amt, min=1e-30)
        valid = amt > cfg.zero_thresh
        n = (cfg.nx, cfg.ny, cfg.nz)[a]
        for edge in (0, n):
            g.select(a, edge).zero_()
            valid.select(a, edge).fill_(True)
        grids.append(g)
        masks.append(valid)
    return (*grids, *masks)


def transfer_to_grid(cfg: SimConfig, pos, vel):
    """P2G by scatter. pos (N, 3) in meters, vel (N, 3)."""
    return _normalise(cfg, p2g_accumulate_plain(cfg, pos * cell_scale(cfg, pos.device), vel))


def p2g_from_csr(cfg: SimConfig, csr: CSR, pcs, vels, x0: int = 0):
    """P2G by gather over the CSR index (ops/binning.py); pcs and vels are
    the particles in its order (ops/binning.py::sort_particles). x0: the
    grid is the x-slab from the domain's plane x0 on (cuda_p2g.py).
    Returns (u, v, w, u_valid, v_valid, w_valid)."""
    return _normalise(cfg, p2g_accumulate(cfg, pcs, vels, csr.start, x0=x0))
