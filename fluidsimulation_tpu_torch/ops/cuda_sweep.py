"""The 24 directional fast sweeps of the level set: the CUDA kernel
(csrc/sweep.cu: one C call runs a list of sweeps, one launch a sweep on the
stream) and its plain PyTorch version.

Replaces fluidsimulation_tpu/ops/pallas_sweep.py (_sweep_kernel via
_sweep_major and sweep_closest_pallas). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel.

``sweep_x_carry`` is one x-sweep of an x-slab continuing the sweep of the
slab before it: the multi-rank level set (parallel/halo_step.py) relays
each x-sweep's last candidate plane from rank to rank.
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
     _build.I, _build.I, _build.I, _build.F, _build.INTS, _build.I, _build.I],
)

# One x-sweep of an x-slab that continues a neighbouring slab's sweep, for
# the relay of parallel/halo_step.py (csrc/sweep.cu::fst_sweep_x_carry).
CARRY_KERNEL = _build.Kernel(
    "fst_sweep_x_carry",
    [_build.P] * 6 + [_build.I] * 4 + [_build.F, _build.I],
)


def _sweep_axis_plain(phi, cpos, centers, r, axis: int, reverse: bool, carry=None):
    """One sweep, in place on (phi, cpos): walk the planes along ``axis``,
    carrying the previous plane's resulting candidate. Without ``carry``
    the first plane is copied; with it, the first plane is held against
    it. Returns the last plane's resulting candidates."""
    n = phi.shape[axis]
    planes = range(n - 1, -1, -1) if reverse else range(n)
    if carry is None:
        carry = cpos.select(axis, planes[0]).clone()
        planes = planes[1:]
    for s in planes:
        ph = phi.select(axis, s)
        cp = cpos.select(axis, s)
        c = centers.select(axis, s)
        d = dist(carry[..., 0], carry[..., 1], carry[..., 2], c[..., 0], c[..., 1], c[..., 2]) - r
        better = d < ph
        carry = torch.where(better[..., None], carry, cp)
        ph.copy_(torch.where(better, d, ph))
        cp.copy_(carry)
    return carry


def _centers(shape, device, x0: int = 0):
    """Cell centres; the grid's x plane 0 is the domain's plane x0."""
    axes = [torch.arange(n, dtype=torch.float32, device=device) for n in shape]
    axes[0] = torch.arange(x0, x0 + shape[0], dtype=torch.float32, device=device)
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def sweeps_plain(cfg: SimConfig, phi, cpos, codes, x0: int = 0):
    r = cfg.particle_radius
    centers = _centers(phi.shape, phi.device, x0)
    phi, cpos = phi.clone(), cpos.clone()
    for code in codes:
        axis, reverse = CODE[code]
        _sweep_axis_plain(phi, cpos, centers, r, axis, reverse)
    return phi, cpos


def sweep_closest_plain(cfg: SimConfig, phi, cpos):
    return sweeps_plain(cfg, phi, cpos, SWEEP_ORDER)


def sweeps(cfg: SimConfig, phi, cpos, codes, x0: int = 0):
    """Run the sweeps of ``codes`` (keys of CODE) in order: one C call, one
    count. ``sweep_closest`` runs SWEEP_ORDER; a sub-list times one axis.

    phi: (nx, ny, nz); cpos: (nx, ny, nz, 3) candidates in cell units.
    x0: the grid is the x-slab from the domain's plane x0 on, and the
    candidates are in the domain's frame (parallel/halo_step.py); 0 for a
    whole grid. Returns the swept (phi, cpos); the inputs are not
    modified."""
    codes = list(codes)
    if not codes or any(c not in CODE for c in codes):
        raise ValueError(f"codes: expected a non-empty list of sweep codes 0-5, got {codes}")
    if phi.device.type == "cpu":
        return sweeps_plain(cfg, phi, cpos, codes, x0)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    dev = _build.same_device(phi, cpos)
    src_phi = _build.check(phi, "phi", (nx, ny, nz))
    src_cpos = _build.check(cpos, "cpos", (nx, ny, nz, 3))
    phi_out = torch.empty_like(phi)
    cpos_out = torch.empty_like(cpos)
    KERNEL.launch(
        dev, src_phi, src_cpos, phi_out.data_ptr(), cpos_out.data_ptr(),
        nx, ny, nz, float(cfg.particle_radius), (ctypes.c_int * len(codes))(*codes), len(codes),
        x0,
    )
    return phi_out, cpos_out


def sweep_closest(cfg: SimConfig, phi, cpos):
    """Run the 24 directional sweeps in the reference order (see sweeps)."""
    return sweeps(cfg, phi, cpos, SWEEP_ORDER)


def sweep_x_carry_plain(cfg: SimConfig, phi, cpos, reverse: bool, carry_in=None, x0: int = 0):
    phi, cpos = phi.clone(), cpos.clone()
    carry = None if carry_in is None else carry_in.clone()
    carry = _sweep_axis_plain(phi, cpos, _centers(phi.shape, phi.device, x0),
                              cfg.particle_radius, 0, reverse, carry)
    return phi, cpos, carry


def sweep_x_carry(cfg: SimConfig, phi, cpos, reverse: bool, carry_in=None, x0: int = 0):
    """One x-sweep (Xm, or Xp when ``reverse``) of the slab (sx, ny, nz)
    from the domain's x plane x0 on, candidates in the domain's frame.
    carry_in: the (ny, nz, 3) candidate plane a neighbouring slab's sweep
    ended with; None copies the first plane, as sweeps() does. Returns
    (phi, cpos, carry_out), carry_out the last plane's resulting
    candidates; the inputs are not modified."""
    if phi.device.type == "cpu":
        return sweep_x_carry_plain(cfg, phi, cpos, reverse, carry_in, x0)
    if phi.dim() != 3:
        raise ValueError(f"phi: expected (sx, ny, nz), got shape {tuple(phi.shape)}")
    sx, ny, nz = shape = tuple(phi.shape)
    dev = _build.same_device(phi, cpos, *(() if carry_in is None else (carry_in,)))
    src_phi = _build.check(phi, "phi", shape)
    src_cpos = _build.check(cpos, "cpos", (*shape, 3))
    src_carry = None if carry_in is None else _build.check(carry_in, "carry_in", (ny, nz, 3))
    phi_out = torch.empty_like(phi)
    cpos_out = torch.empty_like(cpos)
    carry_out = torch.empty((ny, nz, 3), dtype=torch.float32, device=dev)
    CARRY_KERNEL.launch(
        dev, src_phi, src_cpos, phi_out.data_ptr(), cpos_out.data_ptr(), src_carry,
        carry_out.data_ptr(), sx, ny, nz, int(reverse), float(cfg.particle_radius), x0,
    )
    return phi_out, cpos_out, carry_out
