"""Simulation state: a dataclass of tensors.

pos, vel are (N, 3) float32 (meters, m/s); the MAC grids are indexed
[x, y, z] with z contiguous; phi is the cell-centred level set in cell units.
``k1`` is the next step's RK3 stage 1, the grid velocity at ``pos`` that the
FLIP update computes anyway (ops/flip.py); None means advection computes it.

``ApicState`` is the APIC family's state (solver/apic.py): SimState's fields
without k1, plus the affine rows C. The JAX package keeps it in its
solver/apic.py; here it sits beside SimState, so that the checkpoints and
the numpy converters need no solver import.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimConfig
from .seeding import dam_break_particles

_FIELDS = ("pos", "vel", "u", "v", "w", "phi")
_APIC_FIELDS = ("pos", "vel", "C", "u", "v", "w", "phi")


@dataclasses.dataclass
class SimState:
    pos: torch.Tensor
    vel: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    phi: torch.Tensor
    k1: torch.Tensor | None = None

    def to(self, device) -> "SimState":
        """The same state with every tensor on ``device``."""
        return SimState(
            **{name: getattr(self, name).to(device) for name in _FIELDS},
            k1=None if self.k1 is None else self.k1.to(device),
        )


def init_state(cfg: SimConfig, device, with_cache: bool = True) -> SimState:
    """Dam-break initial state (Simulation.cpp:39-90): jittered particle
    block, zero velocities and grids, phi = +inf. With ``with_cache`` the
    state carries k1 = 0, the exact stage-1 value on the zero grids."""
    pos, vel = dam_break_particles(cfg)
    f32 = torch.float32

    def t(a):
        return torch.from_numpy(a).to(device)

    return SimState(
        pos=t(pos),
        vel=t(vel),
        u=torch.zeros(cfg.u_shape(), dtype=f32, device=device),
        v=torch.zeros(cfg.v_shape(), dtype=f32, device=device),
        w=torch.zeros(cfg.w_shape(), dtype=f32, device=device),
        phi=torch.full(cfg.grid_shape(), float("inf"), dtype=f32, device=device),
        k1=torch.zeros_like(t(pos)) if with_cache else None,
    )


def state_from_numpy(src, device) -> SimState:
    """Carry a JAX SimState (or any object with numpy-convertible fields
    pos, vel, u, v, w, phi and cache) onto ``device``. Of the JAX
    AdvectCache only ``k1`` is taken."""
    k1 = None if src.cache is None else src.cache.k1

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return SimState(
        **{name: t(getattr(src, name)) for name in _FIELDS},
        k1=None if k1 is None else t(k1),
    )


def state_to_numpy(state: SimState) -> dict[str, np.ndarray | None]:
    """The state's fields as host numpy arrays (k1 may be None)."""
    out = {name: getattr(state, name).cpu().numpy() for name in _FIELDS}
    out["k1"] = None if state.k1 is None else state.k1.cpu().numpy()
    return out


@dataclasses.dataclass
class ApicState:
    pos: torch.Tensor  # (N, 3) meters
    vel: torch.Tensor  # (N, 3) m/s
    C: torch.Tensor    # (N, 3, 3) 1/s: the affine row of each component
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    phi: torch.Tensor

    def to(self, device) -> "ApicState":
        """The same state with every tensor on ``device``."""
        return ApicState(**{name: getattr(self, name).to(device) for name in _APIC_FIELDS})


def apic_state_from_numpy(src, device) -> ApicState:
    """Carry a JAX ApicState (or any object with numpy-convertible fields
    pos, vel, C, u, v, w and phi) onto ``device``."""
    return ApicState(**{
        name: torch.from_numpy(np.array(getattr(src, name), dtype=np.float32)).to(device)
        for name in _APIC_FIELDS
    })


def apic_state_to_numpy(state: ApicState) -> dict[str, np.ndarray]:
    """The APIC state's fields as host numpy arrays."""
    return {name: getattr(state, name).cpu().numpy() for name in _APIC_FIELDS}
