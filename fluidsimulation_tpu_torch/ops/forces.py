"""Gravity (gpAddBodyForces.hlsl), port of fluidsimulation_tpu/ops/forces.py.

Adds g*dt to the interior V faces only; the wall-normal faces stay 0. The
same in 2D (solver/step2d.py), where v is (nx, ny+1).
"""

from __future__ import annotations

import numpy as np

from ..core.config import SimConfig, SimConfig2D


def add_gravity(cfg: SimConfig | SimConfig2D, v, dt):
    out = v.clone()
    out[:, 1 : cfg.ny] += np.float32(cfg.gravity_y) * np.float32(dt)
    return out
