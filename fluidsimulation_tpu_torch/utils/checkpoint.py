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

The reference's TSV debug IO (debugroutines.h:24-165) is here too, in the
JAX package's text format, byte for byte: a grid as one block of rows y,
columns x, for each z, and a particle as one row of position and velocity,
each value written as Python's repr of the float. They take tensors on any
device or numpy arrays.
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


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def export_array_tsv(path: str, arr) -> None:
    """Grid export (debugroutines.h:24 exportArray): one z-slice block per
    section, rows y, columns x, tab-separated; a 2D array is one block."""
    arr = _host(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    with open(path, "w") as f:
        for z in range(arr.shape[2]):
            for y in range(arr.shape[1]):
                f.write("\t".join(repr(float(v)) for v in arr[:, y, z]))
                f.write("\n")
            f.write("\n")


def import_array_tsv(path: str, shape: tuple[int, ...], device) -> torch.Tensor:
    """The grid export_array_tsv wrote, of ``shape`` (nx, ny[, nz]), as a
    float32 tensor on ``device``."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                vals.extend(float(t) for t in line.split("\t"))
    nz = shape[2] if len(shape) > 2 else 1
    a = np.array(vals, np.float32).reshape(nz, shape[1], shape[0]).transpose(2, 1, 0)
    return torch.from_numpy(np.ascontiguousarray(a if len(shape) > 2 else a[:, :, 0])).to(device)


def export_particles_tsv(path: str, pos, vel) -> None:
    """Particle export (debugroutines.h:165 exportParticles): a row of
    position then velocity a particle."""
    with open(path, "w") as f:
        for p, v in zip(_host(pos), _host(vel)):
            f.write("\t".join(repr(float(x)) for x in (*p, *v)) + "\n")


def l2_norm_diff(a, b) -> float:
    """ComputeL2Norm (debugroutines.h:153): the L2 norm of a - b, summed in
    float64, for diffing two implementations' fields."""
    d = _host(a).astype(np.float64) - _host(b).astype(np.float64)
    return float(np.sqrt((d ** 2).sum()))
