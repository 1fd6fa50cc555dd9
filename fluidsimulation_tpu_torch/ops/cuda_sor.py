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
from .common import shift

KERNEL = _build.Kernel(
    "fst_sor",
    [_build.P] * 7 + [_build.I] * 4 + [_build.F, _build.F],
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
