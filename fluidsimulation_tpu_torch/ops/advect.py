"""Particle advection (RK3, Ralston), port of fluidsimulation_tpu/ops/advect.py.

Stage offsets 0.5*dt and 0.75*dt and weights (2/9, 3/9, 4/9)
(Simulation3D.cpp:211-221); the final position is clamped to
[-0.4/m, 1-0.6/m] (gpAdvect.hlsl:65-67). Scalars are float32, as in the
JAX package's jitted step.

Each stage's grid gather, the interpolation of (u, v, w) at the particles,
is one call of ops/cuda_interp.py::interp_mac3_vec (on the card one launch
of csrc/interp.cu, on the CPU core/interp.py's plain version) in a
``gather`` span of utils/trace.py (inside the step's ``advect`` span):
three a call without k1, two with it. ``_rk3`` looks the name up in this
module at each call, so a hook set on ``ops.advect.interp_mac3_vec`` (the
benchmark's site tables, tests/test_torch_stepped.py) takes every gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SimConfig
from ..utils.trace import span
from .common import cell_scale
from .cuda_interp import interp_mac3_vec


def _rk3(cfg: SimConfig, u, v, w, k1, pos, dt):
    dt = np.float32(dt)
    m = cell_scale(cfg, pos.device)

    def vel_at(p):
        pc = p * m  # outside the span: it holds the interpolation's call alone
        with span("gather"):
            return interp_mac3_vec(u, v, w, pc)

    if k1 is None:
        k1 = vel_at(pos)
    k2 = vel_at(pos + 0.5 * dt * k1)
    k3 = vel_at(pos + 0.75 * dt * k2)
    newpos = pos + dt * ((2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3)
    return torch.clamp(newpos, -0.4 / m, 1.0 - 0.6 / m)


def advect_rk3(cfg: SimConfig, u, v, w, pos, dt):
    """Advect pos through the MAC grids (u, v, w) by dt."""
    return _rk3(cfg, u, v, w, None, pos, dt)


def advect_rk3_cached(cfg: SimConfig, u, v, w, k1, pos, dt):
    """advect_rk3 with stage 1 given: k1 is the grid velocity at pos that
    the previous step's FLIP update computed from these same grids."""
    return _rk3(cfg, u, v, w, k1, pos, dt)


def advect_rk3_pic(cfg: SimConfig, u, v, w, pos, vel, dt):
    """RK3 with stage 1 = the particle's own velocity, for the APIC family
    (solver/apic.py): there vel is the quadratic-spline G2P sample of these
    grids at pos, taken at the end of the previous step, so stage 1 needs no
    gather. Stages 2-3 interpolate as advect_rk3 does (the JAX package uses
    its packed interpolation, equal up to fused multiply-adds). Not for
    FLIP states, whose velocity is a blend, not a grid sample."""
    return _rk3(cfg, u, v, w, vel, pos, dt)
