"""Fused FLIP gather: the CUDA kernel (csrc/g2p.cu) and its plain PyTorch
version.

Replaces fluidsimulation_tpu/core/pallas_pairpack.py (the [diff | new] pair
pack) together with the packed pair interpolation it feeds. Given the new
grids g = (u, v, w), the snapshot g_old taken before gravity and the
projection, and the particles in CSR order, it returns
vel' = beta*vel + interp(g - beta*g_old) and k1 = interp(g) at each
particle, in the particles' original order (beta = 1 - alpha). The kernel
walks the sorted slots and forms the diff grids at each corner; the plain
version forms them in PyTorch. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.config import SimConfig
from ..core.interp import interp_mac3_vec

KERNEL = _build.Kernel(
    "fst_g2p_flip",
    [_build.P] * 10 + [_build.L, _build.I, _build.I, _build.I, _build.F],
)


def g2p_flip_plain(cfg: SimConfig, order, pcs, vels, u, v, w, old_u, old_v, old_w, beta):
    diff = interp_mac3_vec(u - beta * old_u, v - beta * old_v, w - beta * old_w, pcs)
    k1 = interp_mac3_vec(u, v, w, pcs)
    vel_out, k1_out = torch.empty_like(vels), torch.empty_like(k1)
    vel_out[order] = beta * vels + diff
    k1_out[order] = k1
    return vel_out, k1_out


def g2p_flip(cfg: SimConfig, order, pcs, vels, u, v, w, old_u, old_v, old_w, beta):
    """order (N,) int64: the original index of each sorted slot (csr.order,
    a permutation of 0..N-1, which the kernel does not check); pcs (N, 3)
    positions in cell units and vels (N, 3), both in that order (see
    ops/binning.py::sort_particles); u, v, w and old_u, old_v, old_w MAC
    grids; beta = 1 - alpha. Returns (vel', k1), each (N, 3), in the
    original order; from the kernel, the two halves of one (N, 6) array."""
    if pcs.device.type == "cpu":
        return g2p_flip_plain(cfg, order, pcs, vels, u, v, w, old_u, old_v, old_w, beta)
    n = pcs.shape[0]
    dev = _build.same_device(order, pcs, vels, u, v, w, old_u, old_v, old_w)
    shapes = (cfg.u_shape(), cfg.v_shape(), cfg.w_shape())
    grids = [
        _build.check(g, name, shape)
        for g, name, shape in zip(
            (u, v, w, old_u, old_v, old_w),
            ("u", "v", "w", "old_u", "old_v", "old_w"),
            shapes * 2,
        )
    ]
    # One (N, 6) array: a particle's vel' and k1 are one 24 B run, which
    # the kernel writes whole to the particle's original row.
    rows = torch.empty((n, 6), dtype=torch.float32, device=dev)
    vel_out, k1 = rows[:, :3], rows[:, 3:]
    KERNEL.launch(
        dev,
        _build.check(order, "order", (n,), torch.int64),
        _build.check(pcs, "pcs", (n, 3)),
        _build.check(vels, "vels", (n, 3)),
        *grids,
        rows.data_ptr(),
        n, cfg.nx, cfg.ny, cfg.nz, float(beta),
    )
    return vel_out, k1
