"""Checkerboard SOR pressure solve: the CUDA kernel (csrc/sor.cu) and its
plain PyTorch version.

Replaces fluidsimulation_tpu/ops/pallas_sor.py::_sor_kernel (via
sor_pressure_pallas), which the JAX package runs only where its working set
fits VMEM; on the card the kernel is the solve at every grid size. Both
forms start from p = 0 and run ``cfg.sor_iterations`` iterations of colour
0 then colour 1, the red-black order that makes each masked half-update
exact Gauss-Seidel (ops/project.py:74-123 of the JAX package). A CPU tensor
takes the plain version; a CUDA tensor launches the kernel, one C call a
solve: a list-building launch, then one cooperative launch that runs every
half-update with a grid barrier between them.

``sor_half`` is one colour's half-update on an x-slab of the grid, with
the slab's neighbour planes given: the multi-rank solve of
parallel/halo.py launches it 2 x iterations times, exchanging p's boundary
planes between launches (csrc/sor.cu::fst_sor_half).

The grid's shape comes from the tensors, omega and the iteration count from
the config, so the 2D projection (solver/step2d.py) runs the same solve on
(nx, ny, 1) views with SimConfig2D's omega and 120 iterations: its z
neighbours lie outside the grid and subtract an exact 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core.config import SimConfig, SimConfig2D
from .common import shift, shift_with_halo

KERNEL = _build.Kernel(
    "fst_sor",
    [_build.P] * 7 + [_build.I] * 4 + [_build.F, _build.F],
)

# One colour's half-update on an x-slab, for the halo solve of
# parallel/halo.py (ranks exchange p's boundary planes between launches).
HALF_KERNEL = _build.Kernel(
    "fst_sor_half",
    [_build.P] * 8 + [_build.I] * 5 + [_build.F, _build.F],
)


def relaxation(cfg: SimConfig | SimConfig2D) -> tuple[np.float32, np.float32]:
    """(omega, 1 - omega) as float32, omega = 2 - 3.16343/nx in 3D
    (Simulation.cpp:909), 2 - 3.22133/nx in 2D (Simulation2D.cpp:699);
    both forms use these exact values."""
    omega = np.float32(cfg.omega)
    return omega, np.float32(1.0 - omega)


def sor_pressure_plain(cfg: SimConfig | SimConfig2D, phi, diag, b):
    nx, ny, nz = phi.shape
    omega, one_minus_omega = relaxation(cfg)
    fluid = phi < 0.0
    dev = phi.device
    parity = (
        torch.arange(nx, device=dev)[:, None, None]
        + torch.arange(ny, device=dev)[None, :, None]
        + torch.arange(nz, device=dev)[None, None, :]
    ) % 2
    update = [fluid & (parity == color) for color in (0, 1)]
    nb_fluid = [shift(fluid, axis, s, False) for axis in range(3) for s in (-1, 1)]

    def half_update(p, color):
        nms = torch.zeros_like(p)
        k = 0
        for axis in range(3):
            for s in (-1, 1):
                nms = nms - torch.where(nb_fluid[k], shift(p, axis, s, 0.0), 0.0)
                k += 1
        upd = one_minus_omega * p + omega * (b - nms) / diag
        return torch.where(update[color], upd, p)

    p = torch.zeros_like(b)
    for _ in range(cfg.sor_iterations):
        p = half_update(p, 0)
        p = half_update(p, 1)
    return p


def sor_pressure(cfg: SimConfig | SimConfig2D, phi, diag, b):
    """Checkerboard SOR from p = 0 (gpProjectIteration{1,2}.hlsl x100).

    phi, diag, b: (nx, ny, nz) float32. Returns p (nx, ny, nz)."""
    if phi.device.type == "cpu":
        return sor_pressure_plain(cfg, phi, diag, b)
    return sor_launch(cfg, phi, diag, b)[0]


def sor_launch(cfg: SimConfig | SimConfig2D, phi, diag, b):
    """The kernel's solve (CUDA tensors only). Returns p and the kernel's
    int32 counters: the fluid cells of colour 0 and of colour 1, and the
    grid barriers it ran (2 x iterations - 1)."""
    if phi.dim() != 3:
        raise ValueError(f"phi: expected (nx, ny, nz), got shape {tuple(phi.shape)}")
    nx, ny, nz = shape = tuple(phi.shape)
    half = nx * ny * ((nz + 1) // 2)  # room for every cell of one colour
    if 2 * half >= 2**31:
        raise ValueError(f"grid {shape}: the SOR kernel indexes cells with 32-bit ints")
    dev = _build.same_device(phi, diag, b)
    args = [_build.check(t, name, shape) for t, name in ((phi, "phi"), (diag, "diag"), (b, "b"))]
    p = torch.empty(shape, dtype=torch.float32, device=dev)
    # Scratch: a list of 16 B records per colour, and p split by colour.
    lists = torch.empty((2, half, 4), dtype=torch.int32, device=dev)
    split = torch.empty((2, half), dtype=torch.float32, device=dev)
    counters = torch.empty(3, dtype=torch.int32, device=dev)
    omega, one_minus_omega = relaxation(cfg)
    KERNEL.launch(
        dev, *args, p.data_ptr(), lists.data_ptr(), split.data_ptr(), counters.data_ptr(),
        *shape, cfg.sor_iterations, float(omega), float(one_minus_omega),
    )
    return p, counters


def sor_half_plain(cfg: SimConfig | SimConfig2D, p, p_lo, p_hi, phi, phi_lo, phi_hi, diag, b,
                   x0: int, color: int):
    sx, ny, nz = phi.shape
    omega, one_minus_omega = relaxation(cfg)
    dev = phi.device
    parity = (
        (x0 + torch.arange(sx, device=dev))[:, None, None]
        + torch.arange(ny, device=dev)[None, :, None]
        + torch.arange(nz, device=dev)[None, None, :]
    ) % 2
    fluid = phi < 0.0
    nms = torch.zeros_like(p)
    for s in (-1, 1):
        nb = shift_with_halo(fluid, phi_lo < 0.0, phi_hi < 0.0, s)
        nms = nms - torch.where(nb, shift_with_halo(p, p_lo, p_hi, s), 0.0)
    for axis in (1, 2):
        for s in (-1, 1):
            nms = nms - torch.where(shift(fluid, axis, s, False), shift(p, axis, s, 0.0), 0.0)
    upd = one_minus_omega * p + omega * (b - nms) / diag
    p.copy_(torch.where(fluid & (parity == color), upd, p))
    return p


def sor_half(cfg: SimConfig | SimConfig2D, p, p_lo, p_hi, phi, phi_lo, phi_hi, diag, b,
             x0: int, color: int):
    """One colour's half-update, in place on the x-slab p, of the solve of
    sor_pressure: the slab holds global x planes x0 .. x0 + sx - 1 of the
    grid; p_lo, p_hi, phi_lo and phi_hi are the (ny, nz) planes of p and
    phi just before and after it (phi 0 past the domain's edge: not
    fluid). phi, diag, b and p: (sx, ny, nz) float32. omega is the whole
    grid's, from cfg. Returns p."""
    if phi.device.type == "cpu":
        return sor_half_plain(cfg, p, p_lo, p_hi, phi, phi_lo, phi_hi, diag, b, x0, color)
    if phi.dim() != 3 or color not in (0, 1) or x0 < 0:
        raise ValueError(f"sor_half: phi {tuple(phi.shape)}, x0 {x0}, color {color}")
    shape = tuple(phi.shape)
    plane = shape[1:]
    dev = _build.same_device(p, p_lo, p_hi, phi, phi_lo, phi_hi, diag, b)
    ptrs = [_build.check(t, name, s) for t, name, s in (
        (p, "p", shape), (p_lo, "p_lo", plane), (p_hi, "p_hi", plane), (phi, "phi", shape),
        (phi_lo, "phi_lo", plane), (phi_hi, "phi_hi", plane), (diag, "diag", shape),
        (b, "b", shape))]
    omega, one_minus_omega = relaxation(cfg)
    HALF_KERNEL.launch(dev, *ptrs, *shape, x0, color, float(omega), float(one_minus_omega))
    return p
