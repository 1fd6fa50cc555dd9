"""Particles on a stirred nx x ny sheet of cells: P2G takes each cell's
mean particle velocity, and the update sets each particle's velocity to the
mean of its cell's and the stirring swirl's at its position, and moves the
particle, clamped to the sheet. Positions are in cells. The scene has no nz, and the state's fields are
pos, vel and grid, not the 3D dam break's."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    nx: int
    ny: int
    particles_per_cell: int
    swirl: float  # the stirring's angular rate, 1/s
    max_dt: float
    seed: int


@dataclasses.dataclass
class State:
    pos: torch.Tensor  # (N, 2), in cells
    vel: torch.Tensor  # (N, 2)
    grid: torch.Tensor  # (nx, ny, 2): each cell's mean particle velocity


def init(cfg: Config, dev) -> State:
    g = torch.Generator(device=dev).manual_seed(cfg.seed)
    n = cfg.nx * cfg.ny * cfg.particles_per_cell
    size = torch.tensor([cfg.nx, cfg.ny], dtype=torch.float32, device=dev)
    pos = torch.rand(n, 2, generator=g, device=dev) * size
    vel = torch.randn(n, 2, generator=g, device=dev)
    return State(pos, vel, torch.zeros(cfg.nx, cfg.ny, 2, device=dev))


def _cells(cfg: Config, pos):
    c = pos.floor().long()
    return c[:, 0].clamp(0, cfg.nx - 1) * cfg.ny + c[:, 1].clamp(0, cfg.ny - 1)


def p2g(cfg: Config, pos, vel):
    lin = _cells(cfg, pos)
    n = cfg.nx * cfg.ny
    total = torch.zeros(n, 2, device=pos.device).index_add_(0, lin, vel)
    count = torch.zeros(n, device=pos.device).index_add_(0, lin, torch.ones_like(vel[:, 0]))
    return (total / count.clamp(min=1.0)[:, None]).reshape(cfg.nx, cfg.ny, 2)


def update(cfg: Config, pos, vel, grid, dt):
    """(the new velocities, the new positions)."""
    centre = torch.tensor([cfg.nx / 2, cfg.ny / 2], dtype=pos.dtype, device=pos.device)
    r = pos - centre
    swirl = cfg.swirl * torch.stack([-r[:, 1], r[:, 0]], dim=1)
    new = 0.5 * (grid.reshape(-1, 2)[_cells(cfg, pos)] + swirl)
    top = torch.tensor([cfg.nx, cfg.ny], dtype=pos.dtype, device=pos.device) - 1e-3
    return new, torch.minimum((pos + dt * new).clamp(min=0.0), top)


def step(state: State, dt: float, cfg: Config) -> State:
    grid = p2g(cfg, state.pos, state.vel)
    vel, pos = update(cfg, state.pos, state.vel, grid, dt)
    return State(pos, vel, grid)


def check(state: State) -> bool:
    return bool(torch.isfinite(state.pos).all() and torch.isfinite(state.vel).all())
