"""The 24 directional fast sweeps of the level set: the CUDA kernel
(csrc/sweep.cu: one C call runs a list of sweeps, one launch a sweep on the
stream) and its plain PyTorch version.

Replaces fluidsimulation_tpu/ops/pallas_sweep.py (_sweep_kernel via
_sweep_major and sweep_closest_pallas). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..core.config import SimConfig
from .cuda_seed import dist

# Sweep direction table (Simulation.cpp:744-753). Codes: 0=Xm 1=Xp 2=Ym
# 3=Yp 4=Zm 5=Zp; "m" scans forward (looking at -1), "p" scans backward.
SWEEP_ORDER = [
    0, 2, 4,
    1, 2, 4,
    0, 3, 4,
    1, 3, 4,
    0, 2, 5,
    1, 2, 5,
    0, 3, 5,
    1, 3, 5,
]

# code -> (axis, reverse)
CODE = {0: (0, False), 1: (0, True), 2: (1, False), 3: (1, True), 4: (2, False), 5: (2, True)}

KERNEL = _build.Kernel(
    "fst_sweeps",
    [_build.P, _build.P, _build.P, _build.P,
     _build.I, _build.I, _build.I, _build.F, _build.INTS, _build.I],
)


def _sweep_axis_plain(phi, cpos, centers, r, axis: int, reverse: bool):
    """One sweep, in place on (phi, cpos): walk the planes along ``axis``,
    carrying the previous plane's resulting candidate."""
    n = phi.shape[axis]
    planes = range(n - 1, -1, -1) if reverse else range(n)
    carry = cpos.select(axis, planes[0]).clone()
    for s in planes[1:]:
        ph = phi.select(axis, s)
        cp = cpos.select(axis, s)
        c = centers.select(axis, s)
        d = dist(carry[..., 0], carry[..., 1], carry[..., 2], c[..., 0], c[..., 1], c[..., 2]) - r
        better = d < ph
        carry = torch.where(better[..., None], carry, cp)
        ph.copy_(torch.where(better, d, ph))
        cp.copy_(carry)


def sweeps_plain(cfg: SimConfig, phi, cpos, codes):
    r = cfg.particle_radius
    axes = [torch.arange(n, dtype=torch.float32, device=phi.device) for n in phi.shape]
    centers = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    phi, cpos = phi.clone(), cpos.clone()
    for code in codes:
        axis, reverse = CODE[code]
        _sweep_axis_plain(phi, cpos, centers, r, axis, reverse)
    return phi, cpos


def sweep_closest_plain(cfg: SimConfig, phi, cpos):
    return sweeps_plain(cfg, phi, cpos, SWEEP_ORDER)


def sweeps(cfg: SimConfig, phi, cpos, codes):
    """Run the sweeps of ``codes`` (keys of CODE) in order: one C call, one
    count. ``sweep_closest`` runs SWEEP_ORDER; a sub-list times one axis.

    phi: (nx, ny, nz); cpos: (nx, ny, nz, 3) candidates in cell units.
    Returns the swept (phi, cpos); the inputs are not modified."""
    codes = list(codes)
    if not codes or any(c not in CODE for c in codes):
        raise ValueError(f"codes: expected a non-empty list of sweep codes 0-5, got {codes}")
    if phi.device.type == "cpu":
        return sweeps_plain(cfg, phi, cpos, codes)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    dev = _build.same_device(phi, cpos)
    src_phi = _build.check(phi, "phi", (nx, ny, nz))
    src_cpos = _build.check(cpos, "cpos", (nx, ny, nz, 3))
    phi_out = torch.empty_like(phi)
    cpos_out = torch.empty_like(cpos)
    KERNEL.launch(
        dev, src_phi, src_cpos, phi_out.data_ptr(), cpos_out.data_ptr(),
        nx, ny, nz, float(cfg.particle_radius), (ctypes.c_int * len(codes))(*codes), len(codes),
    )
    return phi_out, cpos_out


def sweep_closest(cfg: SimConfig, phi, cpos):
    """Run the 24 directional sweeps in the reference order (see sweeps)."""
    return sweeps(cfg, phi, cpos, SWEEP_ORDER)
