"""The plain reference of the stand-in 2D sheet (tests/newcell/standin2d):
each cell's mean particle velocity, the new velocity halfway between it
and the swirl's, and the clamped move, written from the scene's numbers
alone."""

import torch

FIELDS = ("pos", "vel", "grid")


def step(scene: dict, state: dict, dt: float, dtype=torch.float32) -> dict:
    nx, ny = scene["nx"], scene["ny"]
    pos, vel = state["pos"].to(dtype), state["vel"].to(dtype)
    ix = pos[:, 0].floor().long().clamp(0, nx - 1)
    iy = pos[:, 1].floor().long().clamp(0, ny - 1)
    lin = (ix * ny + iy)[:, None].expand(-1, 2)
    grid = torch.zeros(nx * ny, 2, dtype=dtype, device=pos.device)
    grid.scatter_reduce_(0, lin, vel, "mean", include_self=False)
    rx, ry = pos[:, 0] - nx / 2, pos[:, 1] - ny / 2
    swirl = torch.stack([-ry, rx], dim=1) * scene["swirl"]
    new = (grid.gather(0, lin) + swirl) * 0.5
    moved = pos + new * dt
    top = torch.tensor([nx - 1e-3, ny - 1e-3], dtype=dtype, device=pos.device)
    out = {"pos": torch.minimum(torch.clamp(moved, min=0.0), top), "vel": new,
           "grid": grid.reshape(nx, ny, 2)}
    return {k: t.to(torch.float32) for k, t in out.items()}
