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

The NaN rule (JAX's: NaN in, NaN out, no raise): a particle whose position
is not finite gets the id ncell, past every cell. Its slots follow
start[ncell], so no stage that walks cells reads it, and csr.cell holds
ncell there.

A step gathers its particles into CSR order once (``sort_particles``): the
level-set seed, P2G and the FLIP gather all read the same sorted positions
and velocities.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import SimConfig
from ..utils.trace import sync
from .common import cell_of, cell_scale, far_cell


@dataclasses.dataclass
class CSR:
    order: torch.Tensor  # (N,) int64: original index of each sorted slot
    cell: torch.Tensor   # (N,) int64: linear cell of each sorted slot, ncells if not finite
    start: torch.Tensor  # (ncells+1,) int32: first sorted slot of each cell; start[ncells]
    #                      counts the finite particles


@dataclasses.dataclass
class SortedParticles:
    """A step's particles in CSR order, gathered once (sort_particles)."""

    csr: CSR
    pcs: torch.Tensor   # (N, 3) float32: (pos * cell_scale(cfg))[csr.order], the floats build_csr binned
    vels: torch.Tensor  # (N, 3) float32: vel[csr.order]


def build_csr(cfg: SimConfig, pos) -> CSR:
    """The CSR index of positions in meters."""
    return build_csr_cells(cfg, pos * cell_scale(cfg, pos.device))


def build_csr_cells(cfg: SimConfig, pcs, x0: int = 0) -> CSR:
    """The CSR index of positions in cell units. x0: cfg's grid is the
    x-slab from the domain's plane x0 on, and pcs are in the domain's cell
    units (a rank's extended slab in parallel/halo_step.py); each particle
    must then lie in the slab."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    ncell = nx * ny * nz
    c = cell_of(pcs, far_cell(cfg))
    if x0:
        c[:, 0] -= x0
    # A non-finite particle has far_cell on an axis, so its id is ncell or more.
    lin = ((c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]).clamp_(max=ncell)
    cell, order = torch.sort(lin, stable=True)
    with sync(2):  # on the card, bincount reads lin's minimum and maximum back
        counts = torch.bincount(lin, minlength=ncell + 1)[:ncell]
    start = torch.zeros(ncell + 1, dtype=torch.int32, device=pcs.device)
    start[1:] = torch.cumsum(counts, 0)
    return CSR(order=order, cell=cell, start=start)


def sort_particles(cfg: SimConfig, csr: CSR, pos, vel) -> SortedParticles:
    """The particles in the CSR order of ``csr = build_csr(cfg, pos)``: one
    gather of the cell-unit positions and the velocities."""
    return SortedParticles(csr, (pos * cell_scale(cfg, pos.device))[csr.order], vel[csr.order])
