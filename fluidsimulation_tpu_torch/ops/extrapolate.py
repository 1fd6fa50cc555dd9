"""One-ring velocity extrapolation (gpExtrapolateParticleVelocities.hlsl).

Port of fluidsimulation_tpu/ops/extrapolate.py. An invalid face next to any
valid face takes the mean of its valid 6-neighbours; other invalid faces
become 0. The HLSL kernel reads out-of-bounds as 0 and !isinf(0) holds, so
out-of-bounds neighbours count as valid zeros.
"""

from __future__ import annotations

import torch

from .common import shift


def extrapolate_one_ring(g, valid):
    num = torch.zeros_like(g)
    tot = torch.zeros_like(g)
    for axis in range(3):
        for s in (-1, 1):
            nb_val = shift(g, axis, s, 0.0)
            nb_ok = shift(valid, axis, s, True)
            num = num + nb_ok
            tot = tot + torch.where(nb_ok, nb_val, 0.0)
    mean = torch.where(num > 0, tot / torch.clamp(num, min=1.0), 0.0)
    return torch.where(valid, g, mean)
