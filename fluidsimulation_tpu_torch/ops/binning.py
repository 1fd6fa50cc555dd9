"""Particle -> cell index in compressed-row (CSR) form.

Particles are sorted by their cell, and each cell keeps the offset of its
first particle: cell c holds the sorted slots start[c] : start[c+1]. The
lists are unbounded, as in the reference (gpParticleIndexing.hlsli:28-45),
so every stage that reads the index is exact. This one index does the job of
the JAX package's ops/binning.py, ops/celltable.py and ops/supertable.py.

Cells are linearised as (cx*ny + cy)*nz + cz, the [x, y, z] layout of the
grids, so the three z-neighbours of a cell are adjacent rows. The sort is
stable: within a cell, particles keep their original index order, which the
level-set seed's "lowest index wins" tie rule relies on.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import SimConfig
from .common import cell_of, cell_scale


@dataclasses.dataclass
class CSR:
    order: torch.Tensor  # (N,) int64: original index of each sorted slot
    cell: torch.Tensor   # (N,) int64: linear cell of each sorted slot
    start: torch.Tensor  # (ncells+1,) int32: first sorted slot of each cell


def build_csr(cfg: SimConfig, pos) -> CSR:
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    c = cell_of(pos * cell_scale(cfg, pos.device))
    lin = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
    cell, order = torch.sort(lin, stable=True)
    counts = torch.bincount(lin, minlength=nx * ny * nz)
    start = torch.zeros(nx * ny * nz + 1, dtype=torch.int32, device=pos.device)
    start[1:] = torch.cumsum(counts, 0)
    return CSR(order=order, cell=cell, start=start)
