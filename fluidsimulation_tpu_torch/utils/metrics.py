"""Stability guard (port of fluidsimulation_tpu/utils/metrics.py::velocity_guard)."""

from __future__ import annotations

import torch


def velocity_guard(vel, limit: float = 1e5) -> torch.Tensor:
    """Device-side explosion flag, after the reference's 'Velocity was too
    high!' assert (Simulation3D.cpp:172-175). A 0-dim bool tensor, True when
    every component is finite and below ``limit`` in magnitude."""
    return (vel.abs() < limit).all() & vel.isfinite().all()
