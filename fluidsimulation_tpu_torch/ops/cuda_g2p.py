"""Fused FLIP gather: the CUDA kernel (csrc/g2p.cu) and its plain PyTorch
version.

Replaces fluidsimulation_tpu/core/pallas_pairpack.py (the [diff | new] pair
pack) together with the packed pair interpolation it feeds. Given the diff
grids dg = g - (1-alpha)*g_old and the new grids g, it returns
vel' = (1-alpha)*vel + interp(dg) and k1 = interp(g) at each particle. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.config import SimConfig
from ..core.interp import interp_mac3_vec
from .common import cell_scale

KERNEL = _build.Kernel(
    "fst_g2p_flip",
    [_build.P] * 10 + [_build.L, _build.I, _build.I, _build.I, _build.F],
)


def g2p_flip_plain(cfg: SimConfig, pos, vel, du, dv, dw, u, v, w, beta):
    pc = pos * cell_scale(cfg, pos.device)
    diff = interp_mac3_vec(du, dv, dw, pc)
    k1 = interp_mac3_vec(u, v, w, pc)
    return beta * vel + diff, k1


def g2p_flip(cfg: SimConfig, pos, vel, du, dv, dw, u, v, w, beta):
    """pos (N, 3) in meters, vel (N, 3); du, dv, dw and u, v, w MAC grids;
    beta = 1 - alpha. Returns (vel', k1), each (N, 3)."""
    if pos.device.type == "cpu":
        return g2p_flip_plain(cfg, pos, vel, du, dv, dw, u, v, w, beta)
    n = pos.shape[0]
    dev = _build.same_device(pos, vel, du, dv, dw, u, v, w)
    shapes = (cfg.u_shape(), cfg.v_shape(), cfg.w_shape())
    grids = [
        _build.check(g, name, shape)
        for g, name, shape in zip(
            (du, dv, dw, u, v, w), ("du", "dv", "dw", "u", "v", "w"), shapes * 2
        )
    ]
    vel_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    k1 = torch.empty((n, 3), dtype=torch.float32, device=dev)
    KERNEL.launch(
        dev,
        _build.check(pos, "pos", (n, 3)),
        _build.check(vel, "vel", (n, 3)),
        *grids,
        vel_out.data_ptr(), k1.data_ptr(),
        n, cfg.nx, cfg.ny, cfg.nz, float(beta),
    )
    return vel_out, k1
