"""The 2D PIC/FLIP step, port of fluidsimulation_tpu/solver/step2d.py
(Simulation2D.cpp, FluidSim::Simulate).

  advect (RK3) -> level set (3x3 closest-particle seed, 8 single-axis
  sweeps) -> P2G (hat weights, scatter) -> extrapolate over the whole grid
  -> snapshot old grids -> gravity -> project (RHS, diagonal, SOR x120,
  apply, with the 2D '+' sign in the air-left case) -> FLIP update

The SOR is ops/cuda_sor.py's on (nx, ny, 1) views, with the 2D omega
2 - 3.22133/nx and 120 iterations: csrc/sor.cu on the card, its plain
version on the CPU. The other stages are plain PyTorch: the JAX package has
no Pallas kernel for them. There is no blur and no carried RK3 stage.

Positions are in meters over the unit square; grids are indexed [x, y]:
u (nx+1, ny), v (nx, ny+1), phi (nx, ny) in cell units. Scalars that JAX's
jitted step derives from its traced dt are formed in float32 here too.
Square roots go through float64 (a float64 root rounded to float32 is the
float32 root; PyTorch's CPU float32 sqrt is not always correctly rounded).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import SimConfig2D
from ..core.interp import interp_mac2
from ..core.state import SimState2D, init_state2d
from ..ops.common import index_of, shift
from ..ops.cuda_sor import sor_pressure
from ..ops.forces import add_gravity
from .step3d import pic_flip_alpha

__all__ = [
    "SimState2D", "init_state2d", "advect_rk3", "seed_closest", "compute_level_set",
    "transfer_to_grid", "extrapolate_full", "compute_rhs2d", "compute_diag2d",
    "apply_pressure2d", "project", "flip_update2d", "step2d",
]

FAR = 1.0e9
# The 8 single-axis sweeps (axis, reversed): the Zhao order (x-,y-), (x+,y-),
# (x+,y+), (x-,y+) of Simulation2D.cpp:280-314, axis by axis.
SWEEPS = ((0, False), (1, False), (0, True), (1, False), (0, True), (1, True), (0, False),
          (1, True))


def _scale(cfg: SimConfig2D, device) -> torch.Tensor:
    """The (2,) float32 tensor [nx, ny]: meters times it are cell units."""
    return torch.tensor([cfg.nx, cfg.ny], dtype=torch.float32, device=device)


def _dist(a, b):
    """|a - b| of (..., 2) points: the squares summed in x, y order, the root
    correctly rounded."""
    e = a - b
    return torch.sqrt((e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]).double()).float()


def _interp(cfg: SimConfig2D, u, v, pos):
    """interp_mac2 at positions in meters, stacked (N, 2)."""
    return torch.stack(interp_mac2(u, v, pos[:, 0] * cfg.nx, pos[:, 1] * cfg.ny), dim=-1)


def advect_rk3(cfg: SimConfig2D, u, v, pos, dt):
    """RK3 (Ralston) through the MAC grids, clamped to
    [-0.4/m, 1 - 0.6/m], bounds formed in float32 as JAX does."""
    dt = np.float32(dt)
    m = _scale(cfg, pos.device)
    k1 = _interp(cfg, u, v, pos)
    k2 = _interp(cfg, u, v, pos + 0.5 * dt * k1)
    k3 = _interp(cfg, u, v, pos + 0.75 * dt * k2)
    newpos = pos + dt * ((2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3)
    lo = torch.full_like(m, -0.4) / m
    hi = 1.0 - torch.full_like(m, 0.6) / m
    return torch.clamp(newpos, lo, hi)


def _centers(nx: int, ny: int, device) -> torch.Tensor:
    """(nx, ny, 2) float32 cell centres (x, y) in cell units."""
    xg = torch.arange(nx, dtype=torch.float32, device=device)
    yg = torch.arange(ny, dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(xg, yg, indexing="ij"), dim=-1)


def seed_closest(cfg: SimConfig2D, pos):
    """Each cell's closest own particle, then the 3x3 closest-candidate
    pass. Returns phi (nx, ny) and cpos (nx, ny, 2) in cell units (FAR
    where no candidate reached).

    A particle's cell is floor(p + 0.5), linear id x + nx*y; the lowest
    particle index wins a tie. A cell holding a NaN particle is left
    unseeded, as JAX's scatter-min, which propagates the NaN, leaves it.
    Positions are clamped into the domain by advection, so every finite
    one lies in a cell."""
    nx, ny = cfg.nx, cfg.ny
    r = cfg.particle_radius
    dev = pos.device
    pc = pos * _scale(cfg, dev)
    cell = index_of(torch.floor(pc + 0.5))
    lin = cell[:, 0] + nx * cell[:, 1]
    d = _dist(pc, cell.float()) - r
    n = pos.shape[0]
    best = torch.full((nx * ny,), float("inf"), dtype=torch.float32, device=dev)
    # -inf marks a cell with a NaN particle: no particle's d equals it.
    best.scatter_reduce_(0, lin, torch.where(d.isnan(), float("-inf"), d), "amin")
    win = torch.full((nx * ny,), n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    win.scatter_reduce_(0, lin, torch.where(d == best[lin], idx, n), "amin")
    seeded = win < n
    cpos0 = torch.where(seeded[:, None], pc[torch.where(seeded, win, 0)], FAR)
    cpos0 = cpos0.reshape(ny, nx, 2).transpose(0, 1)

    center = _centers(nx, ny, dev)
    cpad = F.pad(cpos0, (0, 0, 1, 1, 1, 1), value=FAR)
    phi = torch.full((nx, ny), float("inf"), dtype=torch.float32, device=dev)
    cpos = torch.full((nx, ny, 2), FAR, dtype=torch.float32, device=dev)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cand = cpad[1 + dx : 1 + dx + nx, 1 + dy : 1 + dy + ny]
            dist = _dist(cand, center) - r
            better = dist < phi
            phi = torch.where(better, dist, phi)
            cpos = torch.where(better[..., None], cand, cpos)
    return phi, cpos


def _sweep_axis2(phi, cpos, r: float, axis: int, reverse: bool, center):
    """One single-axis sweep: a serial scan over the lines of ``axis``
    (reversed if ``reverse``), each line's cells taking the previous line's
    candidate when it is strictly closer."""
    n = phi.shape[axis]
    order = range(n - 1, -1, -1) if reverse else range(n)
    phi_out, cpos_out = [None] * n, [None] * n
    first = order[0]
    phi_out[first] = phi.select(axis, first)
    carry = cpos_out[first] = cpos.select(axis, first)
    for k in order[1:]:
        phi_k = phi.select(axis, k)
        d = _dist(carry, center.select(axis, k)) - r
        better = d < phi_k
        phi_out[k] = torch.where(better, d, phi_k)
        carry = cpos_out[k] = torch.where(better[..., None], carry, cpos.select(axis, k))
    return torch.stack(phi_out, dim=axis), torch.stack(cpos_out, dim=axis)


def compute_level_set(cfg: SimConfig2D, pos):
    """Seed, then the 8 sweeps of SWEEPS. Returns (phi, cpos)."""
    phi, cpos = seed_closest(cfg, pos)
    center = _centers(cfg.nx, cfg.ny, pos.device)
    for axis, reverse in SWEEPS:
        phi, cpos = _sweep_axis2(phi, cpos, cfg.particle_radius, axis, reverse, center)
    return phi, cpos


def _finish_faces(g, valid, comp_axis: int):
    """Zero the domain-edge faces of a component and mark them valid."""
    for end in (0, -1):
        g.select(comp_axis, end).zero_()
        valid.select(comp_axis, end).fill_(True)


def transfer_to_grid(cfg: SimConfig2D, pos, vel):
    """P2G with hat weights over the 4 nodes a component. Returns
    (u, v, uv, vv): the normalised face values and their validity (weight
    above zero_thresh); domain-edge faces are 0 and valid.

    One index_add_ a node and accumulator, in JAX's node order: on the CPU
    each face then sums its terms as XLA's scatter of the concatenated
    nodes does, bit for bit; on the card index_add_ adds by atomics, in no
    fixed order. A node outside the grid is masked before its index is
    used."""
    nx, ny = cfg.nx, cfg.ny
    dev = pos.device
    p = pos * _scale(cfg, dev)
    out = []
    for comp_axis, shape in ((0, (nx + 1, ny)), (1, (nx, ny + 1))):
        base, frac = [], []
        for ax in range(2):
            c = p[:, ax] + (0.5 if ax == comp_axis else 0.0)
            b = torch.floor(c)
            base.append(index_of(b))
            frac.append(c - b)
        acc = torch.zeros(shape[0] * shape[1], dtype=torch.float32, device=dev)
        amt = torch.zeros_like(acc)
        for ox in (0, 1):
            for oy in (0, 1):
                ix, iy = base[0] + ox, base[1] + oy
                ok = (ix >= 0) & (ix < shape[0]) & (iy >= 0) & (iy < shape[1])
                wx = frac[0] if ox else 1.0 - frac[0]
                wy = frac[1] if oy else 1.0 - frac[1]
                w = torch.where(ok, wx * wy, 0.0)
                lin = torch.where(ok, ix * shape[1] + iy, 0)
                acc.index_add_(0, lin, w * vel[:, comp_axis])
                amt.index_add_(0, lin, w)
        g = (acc / amt.clamp(min=1e-30)).reshape(shape)
        valid = (amt > cfg.zero_thresh).reshape(shape)
        _finish_faces(g, valid, comp_axis)
        out.append((g, valid))
    (u, uv), (v, vv) = out
    return u, v, uv, vv


def extrapolate_full(g, valid, iters: int):
    """Full-grid extrapolation (Simulation2D.cpp:443-581, its
    Manhattan-bucket BFS): ``iters`` masked one-ring fills, each giving
    every invalid face next to a valid one the mean of its valid
    neighbours, then growing the valid set; a face filled in one pass is
    not read until the next. ``iters`` must cover nx + ny."""
    for _ in range(iters):
        gp = F.pad(g, (1, 1, 1, 1))  # out-of-range neighbours: 0, not valid
        vp = F.pad(valid, (1, 1, 1, 1))
        # Neighbours x-1, x+1, y-1, y+1, summed in that order.
        nbs = [(vp[:-2, 1:-1], gp[:-2, 1:-1]), (vp[2:, 1:-1], gp[2:, 1:-1]),
               (vp[1:-1, :-2], gp[1:-1, :-2]), (vp[1:-1, 2:], gp[1:-1, 2:])]
        num = torch.zeros_like(g)
        tot = torch.zeros_like(g)
        for ok, nb in nbs:
            num = num + ok
            tot = tot + torch.where(ok, nb, 0.0)
        fill = ~valid & (num > 0)
        g = torch.where(fill, tot / num.clamp(min=1.0), g)
        valid = valid | fill
    return g


def _interior(n: int, axis: int, device):
    i = torch.arange(n, device=device)
    e = ((i > 0) & (i < n - 1)).to(torch.float32)
    return e.reshape((n, 1) if axis == 0 else (1, n))


def compute_rhs2d(cfg: SimConfig2D, u, v, dt):
    """b = -dx*rho/dt * div(u) per cell."""
    scale = np.float32(-cfg.dx * cfg.rho) / np.float32(dt)
    return scale * (u[1:, :] - u[:-1, :] + v[:, 1:] - v[:, :-1])


def compute_diag2d(cfg: SimConfig2D, phi):
    """Diagonal: 2 + the interior neighbours of the cell, plus the
    ghost-fluid terms; air cells get 1.0."""
    fluid = phi < 0.0
    num = 2.0 + _interior(cfg.nx, 0, phi.device) + _interior(cfg.ny, 1, phi.device)
    recip = 1.0 / torch.where(fluid, phi, -1.0)  # read only where fluid
    ghost = torch.zeros_like(phi)
    for axis in range(2):
        for s in (-1, 1):
            ghost = ghost + torch.clamp(-shift(phi, axis, s, 0.0) * recip, 0.0, cfg.max_ls_ratio)
    return torch.where(fluid, num + ghost, 1.0)


def apply_pressure2d(cfg: SimConfig2D, u, v, p, phi, dt):
    """Pressure-gradient update with 4-case ghost-fluid handling, the wall
    faces zeroed first. The 2D sign quirk: the air-left case adds
    (Simulation2D.cpp:780), where the 3D solver subtracts."""
    maxr = cfg.max_ls_ratio
    scale = np.float32(dt) / np.float32(cfg.rho * cfg.dx)

    def update(grid, axis):
        n = phi.shape[axis]
        phiL, phiR = phi.narrow(axis, 0, n - 1), phi.narrow(axis, 1, n - 1)
        pL, pR = p.narrow(axis, 0, n - 1), p.narrow(axis, 1, n - 1)
        out = grid.clone()
        for end in (0, -1):
            out.select(axis, end).zero_()
        cur = out.narrow(axis, 1, n - 1)
        safeL = torch.where(phiL != 0.0, phiL, -1e-30)
        safeR = torch.where(phiR != 0.0, phiR, -1e-30)
        both = cur - scale * (pR - pL)
        lonly = cur + scale * pL * (1 + torch.clamp(-phiR / safeL, 0.0, maxr))
        ronly = cur + scale * pR * (1 + torch.clamp(-phiL / safeR, 0.0, maxr))
        cur.copy_(torch.where(phiL < 0.0, torch.where(phiR < 0.0, both, lonly),
                              torch.where(phiR < 0.0, ronly, 0.0)))
        return out

    return update(u, 0), update(v, 1)


def project(cfg: SimConfig2D, u, v, phi, dt):
    """The 2D projection (Simulation2D.cpp:593-808): RHS, diagonal, the SOR
    on (nx, ny, 1) views, the pressure-gradient update. Returns (u, v, p)."""
    b = compute_rhs2d(cfg, u, v, dt)
    diag = compute_diag2d(cfg, phi)
    p = sor_pressure(cfg, phi[..., None], diag[..., None], b[..., None])[..., 0]
    u, v = apply_pressure2d(cfg, u, v, p, phi, dt)
    return u, v, p


def flip_update2d(cfg: SimConfig2D, pos, vel, u, v, old_u, old_v, alpha):
    """vel' = (1 - alpha) vel + the grid's change at pos,
    interp(u - (1 - alpha) old_u) (Simulation2D.cpp's PIC/FLIP blend)."""
    diff = _interp(cfg, u - (1 - alpha) * old_u, v - (1 - alpha) * old_v, pos)
    return (1 - alpha) * vel + diff


def step2d(state: SimState2D, dt, cfg: SimConfig2D) -> SimState2D:
    """Advance the 2D state by one (already clamped) dt."""
    pos = advect_rk3(cfg, state.u, state.v, state.pos, dt)
    alpha = pic_flip_alpha(cfg, dt)
    phi, _ = compute_level_set(cfg, pos)
    u, v, uv, vv = transfer_to_grid(cfg, pos, state.vel)
    iters = cfg.nx + cfg.ny + 2
    u = extrapolate_full(u, uv, iters)
    v = extrapolate_full(v, vv, iters)
    old_u, old_v = u, v
    v = add_gravity(cfg, v, dt)
    u, v, _ = project(cfg, u, v, phi, dt)
    vel = flip_update2d(cfg, pos, state.vel, u, v, old_u, old_v, alpha)
    return SimState2D(pos=pos, vel=vel, u=u, v=v, phi=phi)
