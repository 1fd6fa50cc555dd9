"""Initial conditions in NumPy (copy of fluidsimulation_tpu/core/seeding.py).

dam_break_particles replicates GPFluidSim::ResetSimulation
(Simulation.cpp:39-90); noise_grids the CPU solver's random MAC grids
(Simulation3D.cpp:41-71). Both draw from the minstd stream of core/lcg.py.
"""

from __future__ import annotations

import numpy as np

from .config import SimConfig
from .lcg import minstd_uniform_stream


def dam_break_particles(cfg: SimConfig, skip: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Return (pos, vel) float32 arrays of shape (N, 3), N = cfg.num_particles.

    Positions are in meters; velocities are zero.
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    cpm = np.float32(cfg.cells_per_meter)
    ppc = cfg.particles_per_cell_axis

    xs = np.arange(nx // 2, nx - 1, dtype=np.float32)
    ys = np.arange(1, ny - 1, dtype=np.float32)
    zs = np.arange(1, nz - 1, dtype=np.float32)
    us = np.arange(ppc, dtype=np.float32)

    # Loop order: z, y, x, u, v, w (Simulation.cpp:47-59).
    Z, Y, X, U, V, W = np.meshgrid(zs, ys, xs, us, us, us, indexing="ij")

    # Cell base position, offset by -0.25 cells (Simulation.cpp:50-52).
    base = np.stack(
        [
            (X.ravel() - 0.25) / cpm,
            (Y.ravel() - 0.25) / cpm,
            (Z.ravel() - 0.25) / cpm,
        ],
        axis=-1,
    )
    d = np.float32(0.5 / cpm) * (2.0 / ppc)
    if ppc == 2:
        d = np.float32(0.5 / cpm)
    sub = np.stack([U.ravel(), V.ravel(), W.ravel()], axis=-1) * d

    n = base.shape[0]
    jitter = minstd_uniform_stream(3 * n, -0.25, 0.25, seed=cfg.seed, skip=skip).reshape(n, 3)
    pos = (base + sub + jitter / cpm).astype(np.float32)
    vel = np.zeros_like(pos)
    return pos, vel


def noise_grids(cfg: SimConfig, seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random MAC grids (u, v, w) of shapes (nx+1,ny,nz), (nx,ny+1,nz),
    (nx,ny,nz+1), indexed [x, y, z], drawn from one uniform(-0.25, 0.25)
    stream in the reference's fill order (x fastest, then y, then z; U, V, W).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    n_u = (nx + 1) * ny * nz
    n_v = nx * (ny + 1) * nz
    n_w = nx * ny * (nz + 1)
    s = minstd_uniform_stream(n_u + n_v + n_w, -0.25, 0.25, seed=seed)
    u = s[:n_u].reshape(nz, ny, nx + 1).transpose(2, 1, 0)
    v = s[n_u : n_u + n_v].reshape(nz, ny + 1, nx).transpose(2, 1, 0)
    w = s[n_u + n_v :].reshape(nz + 1, ny, nx).transpose(2, 1, 0)
    return (np.ascontiguousarray(u), np.ascontiguousarray(v), np.ascontiguousarray(w))
