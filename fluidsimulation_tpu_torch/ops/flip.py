"""Hybrid PIC/FLIP particle velocity update (gpUpdateParticleVelocities.hlsl).

Port of fluidsimulation_tpu/ops/flip.py:
u_new = (1-alpha)*u_particle + interp(new - (1-alpha)*old), the CPU
solver's single diff-grid interpolation (Simulation3D.cpp:144-165). The
gather also interpolates the new grids at the particle, which is the next
step's RK3 stage 1 (k1). On the card both run in the G2P kernel of
ops/cuda_g2p.py.
"""

from __future__ import annotations

import numpy as np

from ..core.config import SimConfig
from .cuda_g2p import g2p_flip


def flip_update_carry(cfg: SimConfig, pos, vel, u, v, w, old_u, old_v, old_w, alpha):
    """Returns (vel', k1): the blended particle velocities and the new
    grids interpolated at pos."""
    beta = 1.0 - np.float32(alpha)
    du = u - beta * old_u
    dv = v - beta * old_v
    dw = w - beta * old_w
    return g2p_flip(cfg, pos, vel, du, dv, dw, u, v, w, beta)


def flip_update(cfg: SimConfig, pos, vel, u, v, w, old_u, old_v, old_w, alpha):
    """The blended particle velocities alone."""
    return flip_update_carry(cfg, pos, vel, u, v, w, old_u, old_v, old_w, alpha)[0]
