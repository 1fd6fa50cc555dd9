"""Level-set blur before rendering (gpBlur.hlsl), port of
fluidsimulation_tpu/ops/blur.py.

(self + 6 neighbours) / 7, in the race-free Jacobi form the JAX package
uses (the reference blurs in place and tolerates the race). Out-of-bounds
reads are 0. Written as shifts and adds, not a convolution, so no TF32
convolution path can change the result.
"""

from __future__ import annotations

from .common import shift


def blur_phi(phi):
    acc = phi
    for axis in range(3):
        for s in (-1, 1):
            acc = acc + shift(phi, axis, s, 0.0)
    return acc / 7.0
