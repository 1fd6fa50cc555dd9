"""The APIC step, port of fluidsimulation_tpu/solver/apic.py's exact path
(``step_apic(fast=False)``).

The PIC/FLIP step of solver/step3d.py with its transfer pair swapped: P2G
carries each particle's affine rows (ops/apic.py::p2g_apic) and the
particle update is the APIC G2P (pure-PIC velocities and new affine rows)
in place of the FLIP blend, so no old-grid snapshot is kept:

  advect (RK3, stage 1 = the particle's velocity) -> CSR index and sorted
  gather -> level set (seed, 27-neighbourhood pass, 24 sweeps) -> APIC P2G
  -> extrapolate -> gravity -> project (RHS, diagonal, SOR, apply) -> APIC
  G2P -> blur phi

The level set is the port's CSR level set, as in step3d.py. On the card the
27-neighbourhood pass, the sweeps and the SOR are the CUDA kernels of
ops/cuda_*.py; the transfers are plain PyTorch (the JAX package has no
Pallas kernel for them), and the P2G and FLIP kernels are not called. The
JAX package's fast forms (its table-seeded level set and windowed
transfers) are TPU layouts and are not ported.
"""

from __future__ import annotations

import torch

from ..core.config import SimConfig
from ..core.state import ApicState, init_state
from ..ops.advect import advect_rk3_pic
from ..ops.apic import g2p_apic, p2g_apic
from ..ops.binning import build_csr, sort_particles
from ..ops.blur import blur_phi
from ..ops.extrapolate import extrapolate_one_ring
from ..ops.forces import add_gravity
from ..ops.levelset import compute_level_set
from ..ops.project import project

__all__ = ["ApicState", "init_apic_state", "step_apic", "simulate_apic"]


def init_apic_state(cfg: SimConfig, device) -> ApicState:
    """The dam-break state of core/state.py::init_state with C = 0."""
    s = init_state(cfg, device, with_cache=False)
    n = s.pos.shape[0]
    return ApicState(pos=s.pos, vel=s.vel,
                     C=torch.zeros((n, 3, 3), dtype=torch.float32, device=s.pos.device),
                     u=s.u, v=s.v, w=s.w, phi=s.phi)


def step_apic(state: ApicState, dt, cfg: SimConfig) -> ApicState:
    """Advance the APIC state by one (already clamped) dt."""
    pos = advect_rk3_pic(cfg, state.u, state.v, state.w, state.pos, state.vel, dt)
    csr = build_csr(cfg, pos)
    walk = sort_particles(cfg, csr, pos, state.vel)
    phi, _ = compute_level_set(cfg, csr, walk.pcs)
    # P2G in the particles' own order: on the CPU its sums are then JAX's
    # bit for bit (ops/apic.py).
    u, v, w, uv, vv, wv = p2g_apic(cfg, pos, state.vel, state.C)
    # One ring, as the reference: every face G2P reads with a nonzero
    # weight was weighted by P2G (ops/apic.py::extrapolate_rings).
    u = extrapolate_one_ring(u, uv)
    v = extrapolate_one_ring(v, vv)
    w = extrapolate_one_ring(w, wv)
    v = add_gravity(cfg, v, dt)
    u, v, w, _ = project(cfg, u, v, w, phi, dt)
    vel, C = g2p_apic(cfg, pos, u, v, w)
    phi = blur_phi(phi)
    return ApicState(pos=pos, vel=vel, C=C, u=u, v=v, w=w, phi=phi)


def simulate_apic(state: ApicState, dt, cfg: SimConfig, n_steps: int) -> ApicState:
    """Advance n_steps APIC steps."""
    for _ in range(n_steps):
        state = step_apic(state, dt, cfg)
    return state
