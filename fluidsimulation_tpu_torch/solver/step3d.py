"""The 3D solver step, port of fluidsimulation_tpu/solver/step3d.py.

One frame in the order of GPFluidSim::Simulate (Simulation.cpp:513-566):

  advect -> CSR particle index and the one sorted gather -> level set
  (seed, 27-neighbourhood pass, 24 sweeps) -> P2G -> extrapolate ->
  snapshot old grids -> gravity -> project (RHS, diagonal, SOR x100,
  apply) -> FLIP update (+ next k1) -> blur phi

The port runs the semantics of the JAX package's exact path (``fast=False``
and its exact tiers): the CSR index is unbounded, so there are no slot
tables, supercells or overflow tiers, and one path serves every particle
count (ppc 1 and ppc 2 alike). On the card, the 27-neighbourhood pass, the
sweeps, P2G, the SOR and the FLIP gather are the CUDA kernels of
ops/cuda_*.py; the rest is PyTorch.
"""

from __future__ import annotations

import numpy as np

from ..core.config import SimConfig
from ..core.state import SimState
from ..ops.advect import advect_rk3, advect_rk3_cached
from ..ops.binning import build_csr, sort_particles
from ..ops.blur import blur_phi
from ..ops.extrapolate import extrapolate_one_ring
from ..ops.flip import flip_update_carry
from ..ops.forces import add_gravity
from ..ops.levelset import compute_level_set
from ..ops.p2g import p2g_from_csr
from ..ops.project import project
from ..utils.metrics import velocity_guard
from ..utils.trace import span


def pic_flip_alpha(cfg: SimConfig, dt) -> np.float32:
    """alpha = clamp(6*dt*nu*cpm^2, 0, 1) (Simulation.cpp:541), in float32."""
    a = 6.0 * np.float32(dt) * np.float32(cfg.nu * cfg.cells_per_meter**2)
    return np.clip(a, 0.0, 1.0)


def step(state: SimState, dt, cfg: SimConfig) -> SimState:
    """Advance the simulation by one (already clamped) dt.

    A state that carries k1 takes RK3 stage 1 from it, and the step returns
    the next k1; a state without k1 steps without one. Each call is a
    ``step`` span over the stages' spans (utils/trace.py).
    """
    with span("step"):
        with span("advect"):
            if state.k1 is not None:
                pos = advect_rk3_cached(cfg, state.u, state.v, state.w, state.k1, state.pos, dt)
            else:
                pos = advect_rk3(cfg, state.u, state.v, state.w, state.pos, dt)
        vel = state.vel

        with span("csr"):
            csr = build_csr(cfg, pos)
        with span("sort"):
            walk = sort_particles(cfg, csr, pos, vel)  # the step's one sorted gather
        phi, _ = compute_level_set(cfg, csr, walk.pcs)
        with span("p2g"):
            u, v, w, uv, vv, wv = p2g_from_csr(cfg, csr, walk.pcs, walk.vels)

        with span("extrapolate"):
            u = extrapolate_one_ring(u, uv)
            v = extrapolate_one_ring(v, vv)
            w = extrapolate_one_ring(w, wv)
        old_u, old_v, old_w = u, v, w  # snapshot (Simulation.cpp:529-531)

        with span("gravity"):
            v = add_gravity(cfg, v, dt)
        u, v, w, _ = project(cfg, u, v, w, phi, dt)

        alpha = pic_flip_alpha(cfg, dt)
        with span("particle_update"):
            vel, k1 = flip_update_carry(cfg, pos, vel, u, v, w, old_u, old_v, old_w, alpha, walk)
        with span("blur"):
            phi = blur_phi(phi)
        return SimState(
            pos=pos, vel=vel, u=u, v=v, w=w, phi=phi,
            k1=k1 if state.k1 is not None else None,
        )


def step_guarded(state: SimState, dt, cfg: SimConfig):
    """step() plus the reference's stability checks (velocity explosion,
    Simulation3D.cpp:172-175, and NaN guards) as a device-side flag:
    returns (new_state, healthy), healthy a 0-dim bool tensor."""
    out = step(state, dt, cfg)
    healthy = velocity_guard(out.vel) & out.pos.isfinite().all() & out.u.isfinite().all()
    return out, healthy


def simulate(state: SimState, dt, cfg: SimConfig, n_steps: int) -> SimState:
    """Advance n_steps steps."""
    for _ in range(n_steps):
        state = step(state, dt, cfg)
    return state


def clamp_dt(cfg: SimConfig, dt, simulation_rate: float = 1.0) -> float:
    """dt clamp (Simulation.cpp:515): dt*rate clamped to [0, max_dt]."""
    return float(min(max(dt * simulation_rate, 0.0), cfg.max_dt))
