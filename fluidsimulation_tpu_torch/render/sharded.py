"""The tile-sharded frame: the tiles of one frame split over the ranks.

Port of fluidsimulation_tpu/render/sharded.py (``make_sharded_render``).
The level set is replicated (every rank holds phi), the frame's tiles are
listed row by row and padded to a multiple of the ranks, rank r renders the
r-th contiguous block of the list with render/raytrace.py's ``_render_tile``
(the tiled ``render``'s own tile program), and one all-gather of equal
blocks brings every tile to every rank, where the frame is reassembled.
The padding slots render nothing (JAX renders tile (0, 0) there and drops
it) and are dropped. Each pixel is computed by the same operations as in
``render(..., band_rows=tile_h, band_cols=tile_w)``, so the frame is that
one bit for bit. Like the one-device renderer, no hand kernel: plain
PyTorch, and the JAX package's packed textures stay behind.
"""

from __future__ import annotations

import torch

from ..parallel import comm
from .raytrace import _camera, _f32, _render_tile


def make_sharded_render(world: comm.World, width: int, height: int, tile_h: int = 100,
                        tile_w: int = 100, bounces: int = 2, overstep: float = 0.0):
    """frame(phi, cam_pos, cam_right, cam_up, cam_fwd) -> (height, width, 3)
    float32 on every rank, its tiles rendered over the ranks of ``world``.
    phi: the whole (nx, ny, nz) level set on each rank's device; the camera
    vectors as render() takes them. ``overstep``: render()'s outside-march
    mode (0 and 1 exact)."""
    nty, ntx = -(-height // tile_h), -(-width // tile_w)
    n_tiles = nty * ntx
    per = -(-n_tiles // world.size)  # tiles a rank, the list padded to per * size
    mine = range(world.rank * per, min((world.rank + 1) * per, n_tiles))
    ov = _f32(overstep) if overstep and overstep > 1.0 else None

    def frame(phi, cam_pos, cam_right, cam_up, cam_fwd):
        dev = phi.device
        cam = _camera(dev, cam_pos, cam_right, cam_up, cam_fwd)
        block = torch.zeros((per, tile_h, tile_w, 3), dtype=torch.float32, device=dev)
        for slot, t in enumerate(mine):
            y0, x0 = (t // ntx) * tile_h, (t % ntx) * tile_w
            h, w = min(tile_h, height - y0), min(tile_w, width - x0)
            block[slot, :h, :w] = _render_tile(phi, phi, cam, width, height, y0, x0, h, w,
                                               bounces=bounces, overstep=ov)
        tiles = comm.all_gather(world, block)[:n_tiles]
        img = tiles.reshape(nty, ntx, tile_h, tile_w, 3).permute(0, 2, 1, 3, 4)
        return img.reshape(nty * tile_h, ntx * tile_w, 3)[:height, :width].contiguous()

    return frame
