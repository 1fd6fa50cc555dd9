"""Simulation state: a dataclass of tensors.

pos, vel are (N, 3) float32 (meters, m/s); the MAC grids are indexed
[x, y, z] with z contiguous; phi is the cell-centred level set in cell units.
``k1`` is the next step's RK3 stage 1, the grid velocity at ``pos`` that the
FLIP update computes anyway (ops/flip.py); None means advection computes it.

``ApicState`` is the APIC family's state (solver/apic.py): SimState's fields
without k1, plus the affine rows C. The JAX package keeps it in its
solver/apic.py; here it sits beside SimState, so that the checkpoints and
the numpy converters need no solver import.

``SimState2D`` and ``ApicState2D`` are the 2D family's (solver/step2d.py,
solver/apic2d.py): pos, vel (N, 2), the MAC grids u (nx+1, ny) and
v (nx, ny+1) indexed [x, y], phi (nx, ny); the APIC one adds C (N, 2, 2).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimConfig, SimConfig2D
from .seeding import dam_break_particles, reset2d

_FIELDS = ("pos", "vel", "u", "v", "w", "phi")
_APIC_FIELDS = ("pos", "vel", "C", "u", "v", "w", "phi")
_FIELDS_2D = ("pos", "vel", "u", "v", "phi")
_APIC_FIELDS_2D = ("pos", "vel", "C", "u", "v", "phi")


def _tensors(src, fields, device) -> dict[str, torch.Tensor]:
    """The fields of ``src`` (numpy-convertible) as float32 tensors on
    ``device``."""
    return {name: torch.from_numpy(np.array(getattr(src, name), dtype=np.float32)).to(device)
            for name in fields}


def _arrays(state, fields) -> dict[str, np.ndarray]:
    return {name: getattr(state, name).cpu().numpy() for name in fields}


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
    out = _arrays(state, _FIELDS)
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
    return ApicState(**_tensors(src, _APIC_FIELDS, device))


def apic_state_to_numpy(state: ApicState) -> dict[str, np.ndarray]:
    """The APIC state's fields as host numpy arrays."""
    return _arrays(state, _APIC_FIELDS)


@dataclasses.dataclass
class SimState2D:
    pos: torch.Tensor
    vel: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    phi: torch.Tensor

    def to(self, device) -> "SimState2D":
        """The same state with every tensor on ``device``."""
        return SimState2D(**{name: getattr(self, name).to(device) for name in _FIELDS_2D})


@dataclasses.dataclass
class ApicState2D:
    pos: torch.Tensor  # (N, 2) meters
    vel: torch.Tensor  # (N, 2) m/s
    C: torch.Tensor    # (N, 2, 2) 1/s
    u: torch.Tensor
    v: torch.Tensor
    phi: torch.Tensor

    def to(self, device) -> "ApicState2D":
        """The same state with every tensor on ``device``."""
        return ApicState2D(**{name: getattr(self, name).to(device) for name in _APIC_FIELDS_2D})


def init_state2d(cfg: SimConfig2D, device) -> SimState2D:
    """The 2D dam break (core/seeding.py::reset2d): curl-noise grids, the
    particles' velocities sampled from them, phi = +inf."""
    pos, vel, u, v = reset2d(cfg)
    return SimState2D(
        pos=torch.from_numpy(pos).to(device), vel=torch.from_numpy(vel).to(device),
        u=torch.from_numpy(u).to(device), v=torch.from_numpy(v).to(device),
        phi=torch.full((cfg.nx, cfg.ny), float("inf"), dtype=torch.float32, device=device),
    )


def init_apic_state2d(cfg: SimConfig2D, device) -> ApicState2D:
    """init_state2d's dam break with C = 0."""
    s = init_state2d(cfg, device)
    n = s.pos.shape[0]
    return ApicState2D(pos=s.pos, vel=s.vel,
                       C=torch.zeros((n, 2, 2), dtype=torch.float32, device=s.pos.device),
                       u=s.u, v=s.v, phi=s.phi)


def state2d_from_numpy(src, device) -> SimState2D:
    """Carry a JAX SimState2D (or any object with numpy-convertible fields
    pos, vel, u, v and phi) onto ``device``."""
    return SimState2D(**_tensors(src, _FIELDS_2D, device))


def state2d_to_numpy(state: SimState2D) -> dict[str, np.ndarray]:
    """The 2D state's fields as host numpy arrays."""
    return _arrays(state, _FIELDS_2D)


def apic_state2d_from_numpy(src, device) -> ApicState2D:
    """Carry a JAX ApicState2D (or any object with numpy-convertible fields
    pos, vel, C, u, v and phi) onto ``device``."""
    return ApicState2D(**_tensors(src, _APIC_FIELDS_2D, device))


def apic_state2d_to_numpy(state: ApicState2D) -> dict[str, np.ndarray]:
    """The 2D APIC state's fields as host numpy arrays."""
    return _arrays(state, _APIC_FIELDS_2D)
