"""The multi-rank checkerboard SOR: x-slabs and explicit halo exchange.

Port of fluidsimulation_tpu/parallel/halo.py (``_exchange_x``, ``_sor_local``,
``sor_pressure_sharded``). The grid is split along x into equal slabs, one
a rank. Before each half-update every rank swaps its boundary x-planes of p
with its neighbours (comm.exchange_x); the fluid mask's planes (phi's) are
swapped once up front. Parity is taken in global coordinates, and the
domain's edges see a zero, non-fluid halo: the solve is ops/cuda_sor.py's
one-device solve, half-update for half-update.

Each half-update is ops/cuda_sor.py::sor_half: on the card the hand kernel
csrc/sor.cu::fst_sor_half (launched 2 x iterations times a solve), on the
CPU its plain PyTorch version. The one-device solve keeps fst_sor, whose
single cooperative launch leaves no room for an exchange.
"""

from __future__ import annotations

import torch

from ..core.config import SimConfig
from ..ops.cuda_sor import sor_half
from . import comm


def x_slab(world: comm.World, a, nx: int):
    """The rank's slab of a (nx, ...) array: x planes [rank*sx, (rank+1)*sx)."""
    if nx % world.size:
        raise ValueError(f"grid x {nx} must divide over {world.size} ranks")
    sx = nx // world.size
    return a[world.rank * sx:(world.rank + 1) * sx]


def sor_local(cfg: SimConfig, world: comm.World, phi, diag, b, iterations: int):
    """The SOR on this rank's slab: phi, diag, b (sx, ny, nz), the slab
    holding global x planes rank*sx .. rank*sx + sx - 1. Returns p."""
    x0 = world.rank * phi.shape[0]
    phi_lo, phi_hi = comm.exchange_x(world, phi)  # 0 past the edges: not fluid
    p = torch.zeros_like(b)
    for _ in range(iterations):
        for color in (0, 1):
            p_lo, p_hi = comm.exchange_x(world, p)
            sor_half(cfg, p, p_lo, p_hi, phi, phi_lo, phi_hi, diag, b, x0, color)
    return p


def sor_pressure_sharded(cfg: SimConfig, world: comm.World, phi, diag, b,
                         iterations: int | None = None):
    """Checkerboard SOR over the x-slabs of the ranks, from p = 0: each rank
    passes its slab (cfg.nx / world.size, ny, nz) of phi, diag and b and
    gets its slab of p. Equal to ops/cuda_sor.py::sor_pressure on the
    whole grid."""
    sx = cfg.nx // world.size
    if cfg.nx % world.size or tuple(phi.shape) != (sx, cfg.ny, cfg.nz):
        raise ValueError(f"phi {tuple(phi.shape)}: expected this rank's slab "
                         f"({cfg.nx} / {world.size}, {cfg.ny}, {cfg.nz})")
    iters = cfg.sor_iterations if iterations is None else iterations
    return sor_local(cfg, world, phi, diag, b, iters)
