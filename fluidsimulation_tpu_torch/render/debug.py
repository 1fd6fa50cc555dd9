"""Debug views: particle splats over a checkerboard, port of
fluidsimulation_tpu/render/debug.py.

The reference's archival CPU demos drew point sprites over a checkerboard
texture (DebugPoints.fx, DebugPointsQuads.fx, Basic.fx;
FluidSimDemoOld.cpp:256-346, FluidSimDemoOld3D.cpp:263-268). Here each
particle sets one pixel of an (H, W, 3) float32 image. A coordinate's pixel
is its float-to-int truncation clipped into the image; a NaN coordinate
lands on pixel 0, as JAX's conversion gives it.
"""

from __future__ import annotations

import torch


def checkerboard(width: int, height: int, squares: int = 8, *, device):
    """Basic.fx-style checkerboard background, (H, W, 3) in [0, 1]."""
    ys = (torch.arange(height, device=device) * squares // height) % 2
    xs = (torch.arange(width, device=device) * squares // width) % 2
    shade = 0.35 + 0.3 * (ys[:, None] ^ xs[None, :]).to(torch.float32)
    return shade[..., None].expand(height, width, 3)


def _pixel(c, n: int):
    """JAX's clip(c.astype(int32), 0, n - 1): truncation toward zero, NaN to
    0, then the clip (done first, in float, it gives the same index)."""
    return torch.nan_to_num(c, nan=0.0).clamp(0, n - 1).to(torch.int64)


def _splat(img, px, py, col):
    out = img.clone()
    out[py, px] = col
    return out


def splat_particles_2d(pos, width: int, height: int, background=None, color=(0.2, 0.4, 1.0)):
    """Single-pixel splats of 2D particles (meters over the unit square),
    y up (FluidSimDemoOld.cpp point rendering)."""
    img = checkerboard(width, height, device=pos.device) if background is None else background
    px = _pixel(pos[:, 0] * width, width)
    py = _pixel((1.0 - pos[:, 1]) * height, height)
    return _splat(img, px, py, torch.tensor(color, dtype=torch.float32, device=pos.device))


def splat_particles_3d(pos, width: int, height: int, axis: int = 2, background=None,
                       color=(0.2, 0.4, 1.0)):
    """Orthographic view of 3D particles along ``axis`` (default z), shaded
    by depth (FluidSimDemoOld3D.cpp:263-268). Where particles share a pixel
    the one written last is undefined, as in JAX's scatter."""
    img = checkerboard(width, height, device=pos.device) if background is None else background
    keep = [a for a in range(3) if a != axis]
    px = _pixel(pos[:, keep[0]] * width, width)
    py = _pixel((1.0 - pos[:, keep[1]]) * height, height)
    shade = torch.clamp(0.4 + 0.6 * pos[:, axis], 0.0, 1.0)[:, None]
    col = torch.tensor(color, dtype=torch.float32, device=pos.device) * shade
    return _splat(img, px, py, col)
