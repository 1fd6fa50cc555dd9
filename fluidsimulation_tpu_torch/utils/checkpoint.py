"""Checkpoint and resume in the JAX package's npz format (port of
fluidsimulation_tpu/utils/checkpoint.py::save_state / load_state and
save_apic_state / load_apic_state).

One compressed .npz holds the state's fields as float32 arrays (pos, vel,
u, v, w and phi; an APIC state adds C) and, when a config is given, the row
``_cfg`` = [nx, ny, nz, cells_per_meter] as float64. The keys and the row
are the JAX package's, so each package loads the other's checkpoints. The
carried RK3 stage 1 (``k1``) is not saved, as the JAX package skips its
AdvectCache: a loaded state has k1 = None and its first step computes
stage 1 itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.state import ApicState, SimState

_FIELDS = ("pos", "vel", "u", "v", "w", "phi")
_APIC_FIELDS = ("pos", "vel", "C", "u", "v", "w", "phi")


def _cfg_row(cfg: SimConfig) -> np.ndarray:
    return np.array([cfg.nx, cfg.ny, cfg.nz, cfg.cells_per_meter], np.float64)


def _save(path: str, state, fields, cfg: SimConfig | None) -> None:
    arrays = {k: getattr(state, k).detach().cpu().numpy() for k in fields}
    if cfg is not None:
        arrays["_cfg"] = _cfg_row(cfg)
    np.savez_compressed(path, **arrays)


def _load(path: str, device, fields, cfg: SimConfig | None) -> dict[str, torch.Tensor]:
    """The checkpoint's fields on ``device``. With ``cfg``, raise if its
    recorded grid or its phi shape disagrees with it (a mismatched resume
    would hand the step arrays inconsistent with its config)."""
    with np.load(path) as z:
        arrays = {k: np.asarray(z[k], dtype=np.float32) for k in fields}
        stored = tuple(z["_cfg"]) if "_cfg" in z else None
    if cfg is not None:
        want = tuple(_cfg_row(cfg))
        if stored is not None and stored != want:
            raise ValueError(f"checkpoint cfg {stored} != requested {want}")
        if arrays["phi"].shape != cfg.grid_shape():
            raise ValueError(
                f"checkpoint phi shape {arrays['phi'].shape} != cfg grid {cfg.grid_shape()}"
            )
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def save_state(path: str, state: SimState, cfg: SimConfig | None = None) -> None:
    _save(path, state, _FIELDS, cfg)


def load_state(path: str, device, cfg: SimConfig | None = None) -> SimState:
    """Load a state onto ``device``; with ``cfg``, check it (``_load``)."""
    return SimState(**_load(path, device, _FIELDS, cfg))


def save_apic_state(path: str, state: ApicState, cfg: SimConfig | None = None) -> None:
    """save_state for an ApicState (adds the C rows)."""
    _save(path, state, _APIC_FIELDS, cfg)


def load_apic_state(path: str, device, cfg: SimConfig | None = None) -> ApicState:
    """load_state for an ApicState."""
    return ApicState(**_load(path, device, _APIC_FIELDS, cfg))
