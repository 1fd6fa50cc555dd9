"""Level set from particles: own-cell seed, 27-neighbourhood pass, 24 sweeps.

Port of fluidsimulation_tpu/ops/levelset.py (gpComputeClosestParticleNeighbors
.hlsl plus the 24 gpClosestParticlesSweep dispatches, Simulation.cpp:718-798).
Each cell carries the position of its closest particle candidate. The seed
picks, in each cell, the particle at the smallest distance from the cell
centre, the lowest particle index winning a tie (the reference keeps the
first it finds). The neighbourhood pass and the sweeps are CUDA kernels on
the card (ops/cuda_seed.py, ops/cuda_sweep.py).
"""

from __future__ import annotations

import torch

from ..core.config import SimConfig
from ..utils.trace import span
from .binning import CSR
from .common import cell_of, far_cell
from .cuda_seed import FAR, dist, neighborhood_pass
from .cuda_sweep import SWEEP_ORDER, sweep_closest

__all__ = [
    "FAR", "SWEEP_ORDER", "seed_own_cell", "neighborhood_pass",
    "sweep_closest", "compute_level_set",
]


def seed_own_cell(cfg: SimConfig, csr: CSR, pcs):
    """Each cell's closest own particle.

    pcs: (N, 3) positions in cell units, in the CSR order of ``csr``
    (ops/binning.py::sort_particles). Returns cpos0
    (nx, ny, nz, 3) in cell units, FAR where a cell holds no particle. A
    particle whose position is not finite has csr.cell = ncell: it lands in
    an extra last entry of the scatters, which is dropped."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    ncell = nx * ny * nz
    dev = pcs.device
    if pcs.shape[0] == 0:  # a rank's slab may hold none (parallel/halo_step.py)
        return torch.full((nx, ny, nz, 3), FAR, dtype=torch.float32, device=dev)
    cf = cell_of(pcs, far_cell(cfg)).float()
    d = dist(pcs[:, 0], pcs[:, 1], pcs[:, 2], cf[:, 0], cf[:, 1], cf[:, 2]) - cfg.particle_radius
    best = torch.full((ncell + 1,), float("inf"), dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, csr.cell, d, "amin")
    # Sorted slots keep original index order within a cell (stable sort),
    # so the lowest winning slot is the lowest winning particle index.
    n = pcs.shape[0]
    slot = torch.arange(n, device=dev)
    win = torch.full((ncell + 1,), n, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, csr.cell, torch.where(d == best[csr.cell], slot, n), "amin")
    win = win[:ncell]
    seeded = win < n
    cpos0 = torch.where(seeded[:, None], pcs[torch.where(seeded, win, 0)], FAR)
    return cpos0.reshape(nx, ny, nz, 3)


def compute_level_set(cfg: SimConfig, csr: CSR, pcs):
    """Seed, 27-neighbourhood pass and 24 sweeps; pcs as seed_own_cell
    takes them. Returns (phi, cpos). A ``level_set`` span over the
    ``seed``, ``pass`` and ``sweeps`` spans."""
    with span("level_set"):
        with span("seed"):
            cpos0 = seed_own_cell(cfg, csr, pcs)
        with span("pass"):
            phi, cpos = neighborhood_pass(cfg, cpos0)
        with span("sweeps"):
            return sweep_closest(cfg, phi, cpos)

