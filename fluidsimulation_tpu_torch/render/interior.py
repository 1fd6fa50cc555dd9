"""The certified interior distance that the sphere-trace skip reads.

Port of deepen_phi and its distance transform from
fluidsimulation_tpu/render/interior.py. Inside the fluid the raw level set
saturates at about minus the particle radius, so it says nothing of depth.
``l1_distance_to_nonneg`` gives each node its L1 (Manhattan) distance, in
cells, to the nearest node with phi >= 0; ``deepen_phi`` writes the
Euclidean lower bound L1/sqrt(3) into the nodes deeper than a buffer, so
the inside march of render/raytrace.py can skip by the distance sample it
has already read.

The transform is log-doubling min-plus passes by shifts (s = 1, 2, 4, ...
along each axis; exact, since coverage after shift 2^k is 2^(k+1) - 1).
Every value is a small integer or the +BIG edge, so the result is exact in
float32 and equal to JAX's bit for bit. The interior-skip texture of the
JAX module (PackedPhiSkip, probe_skip) is not ported: that mode was
measured dead.
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 1.0e6
_INV_SQRT3 = float(np.float32(0.57735026))


def _shift_min_plus(f, s: int, axis: int):
    """min(f, f[... i+s ...] + s, f[... i-s ...] + s) with +BIG edges; s < n."""
    n = f.shape[axis]
    edge_shape = list(f.shape)
    edge_shape[axis] = s
    edge = torch.full(edge_shape, _BIG, dtype=f.dtype, device=f.device)
    fwd = torch.cat([f.narrow(axis, s, n - s), edge], dim=axis)
    bwd = torch.cat([edge, f.narrow(axis, 0, n - s)], dim=axis)
    return torch.minimum(f, torch.minimum(fwd, bwd) + float(s))


def l1_distance_to_nonneg(phi):
    """Per-node L1 distance (in cells) to the nearest node with phi >= 0;
    +BIG where the grid has none."""
    f = torch.where(phi >= 0.0, 0.0, _BIG)
    for axis in range(3):
        s = 1
        while s < phi.shape[axis]:
            f = _shift_min_plus(f, s, axis)
            s *= 2
    return f


def deepen_phi(phi, buffer: float = 3.0):
    """phi with the nodes deeper than ``buffer`` cells (by the certified
    Euclidean bound L1/sqrt(3)) set to -(L1/sqrt(3)). The values stay
    strictly negative there, so the march's exits, its backward refine and
    the surface gradients (whose taps reach about 2.3 cells) are unchanged;
    only the sphere-trace skip reads the depth."""
    d = l1_distance_to_nonneg(phi) * _INV_SQRT3
    return torch.where(d >= float(np.float32(buffer)), -d, phi)
