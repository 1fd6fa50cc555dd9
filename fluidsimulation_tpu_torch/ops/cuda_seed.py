"""The 27-neighbourhood closest-candidate pass: the CUDA kernel
(csrc/seed.cu) and its plain PyTorch version.

Replaces fluidsimulation_tpu/ops/pallas_seed.py::neighborhood_pass_pallas.
The kernel stages a tile's candidates through shared memory and takes one
square root a cell, that of the least squared distance; it is bit for bit
the plain version. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from ..core.config import SimConfig

# Candidate coordinate of a cell with no particle. A large finite value
# keeps the distance arithmetic free of NaN; any real candidate beats it.
FAR = 1.0e9

KERNEL = _build.Kernel(
    "fst_neighborhood_pass",
    [_build.P, _build.P, _build.P, _build.I, _build.I, _build.I, _build.F],
)


def dist(ax, ay, az, bx, by, bz):
    """|a - b|, summed in x, y, z order with each step rounded, as the
    kernels compute it."""
    ex, ey, ez = ax - bx, ay - by, az - bz
    return torch.sqrt(ex * ex + ey * ey + ez * ez)


def neighborhood_pass_plain(cfg: SimConfig, cpos0):
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = cfg.particle_radius
    dev = cpos0.device
    cpad = F.pad(cpos0, (0, 0, 1, 1, 1, 1, 1, 1), value=FAR)
    xg = torch.arange(nx, dtype=torch.float32, device=dev)[:, None, None]
    yg = torch.arange(ny, dtype=torch.float32, device=dev)[None, :, None]
    zg = torch.arange(nz, dtype=torch.float32, device=dev)[None, None, :]
    phi = torch.full((nx, ny, nz), float("inf"), dtype=torch.float32, device=dev)
    cpos = torch.full((nx, ny, nz, 3), FAR, dtype=torch.float32, device=dev)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cand = cpad[1 + dx : 1 + dx + nx, 1 + dy : 1 + dy + ny, 1 + dz : 1 + dz + nz]
                d = dist(cand[..., 0], cand[..., 1], cand[..., 2], xg, yg, zg) - r
                better = d < phi
                phi = torch.where(better, d, phi)
                cpos = torch.where(better[..., None], cand, cpos)
    return phi, cpos


def neighborhood_pass(cfg: SimConfig, cpos0):
    """Each cell takes the best of its 27 neighbour cells' own-cell
    candidates (gpComputeClosestParticleNeighbors.hlsl:89-109).

    cpos0: (nx, ny, nz, 3) candidates in cell units, FAR where none.
    Returns (phi (nx, ny, nz), cpos (nx, ny, nz, 3))."""
    if cpos0.device.type == "cpu":
        return neighborhood_pass_plain(cfg, cpos0)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    src = _build.check(cpos0, "cpos0", (nx, ny, nz, 3))
    phi = torch.empty((nx, ny, nz), dtype=torch.float32, device=cpos0.device)
    cpos = torch.empty((nx, ny, nz, 3), dtype=torch.float32, device=cpos0.device)
    KERNEL.launch(
        cpos0.device, src, phi.data_ptr(), cpos.data_ptr(),
        nx, ny, nz, float(cfg.particle_radius),
    )
    return phi, cpos
