"""Runtime metrics and stability guards (port of
fluidsimulation_tpu/utils/metrics.py).

The reference's anomaly prints and velocity-explosion asserts
(Simulation3D.cpp:166-175) become a steps-per-second meter, a device-side
explosion flag and a host-side state check.
"""

from __future__ import annotations

import logging
import time

import torch

log = logging.getLogger("fluidsimulation_tpu_torch")


class Meter:
    """Steps-per-second accounting (the reference shows frame stats in the
    window title, d3dApp.cpp:507 CalculateFrameStats)."""

    def __init__(self, num_particles: int):
        self.num_particles = num_particles
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def particles_per_sec(self) -> float:
        return self.steps_per_sec * self.num_particles

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self.elapsed:.2f}s = "
            f"{self.steps_per_sec:.2f} steps/s, "
            f"{self.particles_per_sec:.3e} particles/s"
        )


def velocity_guard(vel, limit: float = 1e5) -> torch.Tensor:
    """Device-side explosion flag, after the reference's 'Velocity was too
    high!' assert (Simulation3D.cpp:172-175). A 0-dim bool tensor, True when
    every component is finite and below ``limit`` in magnitude."""
    return (vel.abs() < limit).all() & vel.isfinite().all()


def check_state(state, limit: float = 1e5) -> bool:
    """Host-side check; logs and returns False on an anomaly (a non-finite
    field, or a particle speed component above ``limit``)."""
    ok = True
    for name in ("pos", "vel", "u", "v", "w", "phi"):
        if not bool(getattr(state, name).isfinite().all()):
            log.error("non-finite values in %s", name)
            ok = False
    if float(state.vel.abs().max()) > limit:
        log.error("velocity explosion (|v| > %g)", limit)
        ok = False
    return ok
