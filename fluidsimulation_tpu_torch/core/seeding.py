"""Initial conditions in NumPy (copy of fluidsimulation_tpu/core/seeding.py
and of the 2D oracle's init, fluidsimulation_tpu/reference/solver2d.py).

dam_break_particles replicates GPFluidSim::ResetSimulation
(Simulation.cpp:39-90); noise_grids the CPU solver's random MAC grids
(Simulation3D.cpp:41-71); reset2d the 2D solver's FluidSim::Reset
(Simulation2D.cpp:38-78, 810-845). All draw from the minstd stream of
core/lcg.py.
"""

from __future__ import annotations

import numpy as np

from .config import SimConfig, SimConfig2D
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


# -- 2D: curl-noise grids and the dam break (Simulation2D.cpp:38-78, 810-845),
# in float64 as the 2D oracle computes them, cast to float32 at the end.

def peaks(x, y):
    return (
        3.0 * (1.0 - x) ** 2 * np.exp(-x * x - (y + 1.0) ** 2)
        - 10.0 * (0.2 * x - x**3 + y**5) * np.exp(-x * x - y * y)
        - np.exp(-((x + 1.0) ** 2) - y * y) / 3.0
    )


def vector_function(x, y):
    eps = 1e-5
    p0 = peaks(x, y)
    dx = (peaks(x + eps, y) - p0) / eps
    dy = (peaks(x, y + eps) - p0) / eps
    return dx, dy


def vector_curl(x, y):
    fx, fy = vector_function(6.0 * x - 3.0, 6.0 * y - 3.0)
    return 0.1 * fy, -0.1 * fx


def _interp_mac2_numpy(u, v, pi, pj):
    """The 2D MAC interpolation (Simulation2D.h:59-100) in NumPy, for the
    particles' initial velocities."""
    nx = u.shape[0] - 1
    ny = v.shape[1] - 1

    def split_n(c, m):
        n = np.clip(c, 0.0, m - 1.0)
        i = np.minimum(np.floor(n), m - 2.0)
        return i.astype(np.int64), (n - i).astype(np.float32)

    def split_e(c, m):
        e = np.clip(c + 0.5, 0.0, float(m))
        i = np.minimum(np.floor(e), m - 1.0)
        return i.astype(np.int64), (e - i).astype(np.float32)

    iI, fI = split_n(pi, nx)
    iJ, fJ = split_n(pj, ny)
    iEI, fEI = split_e(pi, nx)
    iEJ, fEJ = split_e(pj, ny)

    def bi(g, i, j, fi, fj):
        def lerp(a, b, t):
            return a + (b - a) * t

        return lerp(lerp(g[i, j], g[i + 1, j], fi), lerp(g[i, j + 1], g[i + 1, j + 1], fi), fj)

    return bi(u, iEI, iJ, fEI, fJ), bi(v, iI, iEJ, fI, fEJ)


def reset2d(cfg: SimConfig2D) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The 2D dam break: (pos (N, 2), vel (N, 2), u (nx+1, ny), v (nx, ny+1)),
    float32. u and v are the curl-noise field of 'peaks'; the particles fill
    x in [nx/2, nx-1), y in [1, ny-1), 2x2 a cell, in loop order y, x, u, v
    with 2 jitter draws a particle, and take the grid velocity at their
    position."""
    nx, ny = cfg.nx, cfg.ny
    cpm = cfg.cells_per_meter
    xs = np.arange(nx + 1, dtype=np.float64) / cpm
    yc = (np.arange(ny, dtype=np.float64) + 0.5) / cpm
    u = np.empty((nx + 1, ny), np.float32)
    u[:, :], _ = vector_curl(xs[:, None], yc[None, :])
    xc = (np.arange(nx, dtype=np.float64) + 0.5) / cpm
    ys = np.arange(ny + 1, dtype=np.float64) / cpm
    _, vy = vector_curl(xc[:, None], ys[None, :])
    v = vy.astype(np.float32)

    ys_ = np.arange(1, ny - 1, dtype=np.float32)
    xs_ = np.arange(nx // 2, nx - 1, dtype=np.float32)
    us = np.arange(2, dtype=np.float32)
    Y, X, U, V = np.meshgrid(ys_, xs_, us, us, indexing="ij")
    base = np.stack([(X.ravel() - 0.25) / cpm, (Y.ravel() - 0.25) / cpm], axis=-1)
    sub = np.stack([U.ravel(), V.ravel()], axis=-1) * np.float32(0.5 / cpm)
    n = len(base)
    jitter = minstd_uniform_stream(2 * n, -0.25, 0.25, seed=cfg.seed).reshape(n, 2)
    pos = (base + sub + jitter / cpm).astype(np.float32)
    vel = np.stack(_interp_mac2_numpy(u, v, nx * pos[:, 0], ny * pos[:, 1]),
                   axis=-1).astype(np.float32)
    return pos, vel, u, v
