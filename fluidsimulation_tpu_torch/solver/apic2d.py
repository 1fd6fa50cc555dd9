"""The 2D APIC step, port of fluidsimulation_tpu/solver/apic2d.py.

solver/step2d.py's stages (advect, the 2D level set, the full-grid
extrapolation and the 2D projection) with the transfer pair of
ops/apic.py in 2D: quadratic B-spline weights over the 9 nodes of a
component, affine rows C (N, 2, 2) with C = 4 B m^2 per axis. No old-grid
snapshot is kept, as the G2P replaces the FLIP blend:

  advect -> level set -> APIC P2G -> extrapolate -> gravity -> project ->
  APIC G2P

The transfers are plain PyTorch (the JAX package has no Pallas kernel for
them); the SOR is csrc/sor.cu on the card, as in step2d.
"""

from __future__ import annotations

import itertools

import torch

from ..core.config import SimConfig2D
from ..core.state import ApicState2D, init_apic_state2d
from ..ops.apic import _axis_nodes
from ..ops.forces import add_gravity
from ..utils.trace import span
from .step2d import (
    _finish_faces,
    _scale,
    advect_rk3,
    compute_level_set,
    extrapolate_full,
    project,
)

__all__ = ["ApicState2D", "init_apic_state2d", "p2g_apic2d", "g2p_apic2d", "step_apic2d"]

APIC2D_WEIGHT_THRESH = 1e-4


def _nodes2(cfg: SimConfig2D, pc, comp_axis: int):
    """Yield (idx2, ok, w, dxm) for the 9 spline nodes of one component in
    JAX's order (ox outer, oy inner): the node's two int64 indices, its
    in-range mask, its weight w_x * w_y and its lever x_i - x_p in meters.
    A NaN coordinate gets base node 0 (ops/apic.py::_axis_nodes)."""
    dims = (cfg.nx, cfg.ny)
    m = _scale(cfg, pc.device)
    axes = [
        _axis_nodes(pc[:, ax] + (0.5 if ax == comp_axis else 0.0),
                    dims[ax] + (1 if ax == comp_axis else 0), m[ax])
        for ax in range(2)
    ]
    for ox, oy in itertools.product(range(3), repeat=2):
        (ix, okx, wx, lx), (iy, oky, wy, ly) = axes[0][ox], axes[1][oy]
        yield [ix, iy], okx & oky, wx * wy, [lx, ly]


def p2g_apic2d(cfg: SimConfig2D, pos, vel, C):
    """2D APIC P2G. Returns (u, v, uv, vv) with step2d's transfer_to_grid
    semantics: validity is weight above APIC2D_WEIGHT_THRESH; wall faces are
    0 and valid. One index_add_ a node and accumulator, in JAX's node
    order (ops/apic.py)."""
    nx, ny = cfg.nx, cfg.ny
    pc = pos * _scale(cfg, pos.device)
    out = []
    for comp_axis, shape in ((0, (nx + 1, ny)), (1, (nx, ny + 1))):
        pv = vel[:, comp_axis]
        crow = C[:, comp_axis, :]
        acc = torch.zeros(shape[0] * shape[1], dtype=torch.float32, device=pos.device)
        amt = torch.zeros_like(acc)
        for idx, ok, w, dxm in _nodes2(cfg, pc, comp_axis):
            val = pv + crow[:, 0] * dxm[0] + crow[:, 1] * dxm[1]
            lin = torch.where(ok, idx[0] * shape[1] + idx[1], 0)
            w = torch.where(ok, w, 0.0)
            acc.index_add_(0, lin, w * val)
            amt.index_add_(0, lin, w)
        g = (acc / amt.clamp(min=1e-30)).reshape(shape)
        valid = (amt > APIC2D_WEIGHT_THRESH).reshape(shape)
        _finish_faces(g, valid, comp_axis)
        out.append((g, valid))
    (u, uv), (v, vv) = out
    return u, v, uv, vv


def g2p_apic2d(cfg: SimConfig2D, pos, u, v):
    """2D APIC G2P with clamp addressing. Returns vel (N, 2) and C (N, 2, 2),
    C[:, k, ax] = 4 m[ax]^2 sum_i w_ip v_i (x_i - x_p)[ax]."""
    m = _scale(cfg, pos.device)
    pc = pos * m
    n = pos.shape[0]
    scale = 4.0 * m * m
    vels, crows = [], []
    for comp_axis, grid in ((0, u), (1, v)):
        gflat = grid.reshape(-1)
        sx, sy = grid.shape
        vk = torch.zeros(n, dtype=torch.float32, device=pos.device)
        brow = [torch.zeros_like(vk), torch.zeros_like(vk)]
        for idx, _ok, wgt, dxm in _nodes2(cfg, pc, comp_axis):
            wg = wgt * gflat[idx[0].clamp(0, sx - 1) * sy + idx[1].clamp(0, sy - 1)]
            vk = vk + wg
            brow = [b + wg * lever for b, lever in zip(brow, dxm)]
        vels.append(vk)
        crows.append(torch.stack([brow[0] * scale[0], brow[1] * scale[1]], -1))
    return torch.stack(vels, -1), torch.stack(crows, 1)


def step_apic2d(state: ApicState2D, dt, cfg: SimConfig2D) -> ApicState2D:
    """Advance the 2D APIC state by one (already clamped) dt: a ``step``
    span over the stages' spans (utils/trace.py)."""
    with span("step"):
        with span("advect"):
            pos = advect_rk3(cfg, state.u, state.v, state.pos, dt)
        phi, _ = compute_level_set(cfg, pos)
        with span("p2g"):
            u, v, uv, vv = p2g_apic2d(cfg, pos, state.vel, state.C)
        iters = cfg.nx + cfg.ny + 2
        with span("extrapolate"):
            u = extrapolate_full(u, uv, iters)
            v = extrapolate_full(v, vv, iters)
        with span("gravity"):
            v = add_gravity(cfg, v, dt)
        u, v, _ = project(cfg, u, v, phi, dt)
        with span("particle_update"):
            vel, C = g2p_apic2d(cfg, pos, u, v)
        return ApicState2D(pos=pos, vel=vel, C=C, u=u, v=v, phi=phi)
