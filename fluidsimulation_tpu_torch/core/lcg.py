"""Deterministic minstd LCG in NumPy (copy of fluidsimulation_tpu/core/lcg.py).

x <- 48271*x mod (2^31 - 1), seed 0 mapped to 1, and the single-draw mapping
u = (x-1)/(m-1) -> lo + u*(hi-lo). Both packages consume the same stream, so
their dam-break states are bit-identical.
"""

from __future__ import annotations

import numpy as np

_M = 2147483647  # 2^31 - 1
_A = 48271


def minstd_stream(n: int, seed: int = 0, skip: int = 0) -> np.ndarray:
    """Return n raw minstd states for `seed` after skipping `skip` draws.

    Block-steps with the jump factor a^B mod m, so a million draws need no
    Python loop per draw.
    """
    seed = seed % _M
    s0 = seed if seed != 0 else 1
    if skip:
        s0 = (pow(_A, skip, _M) * s0) % _M
    out = np.empty(n, dtype=np.int64)
    B = 4096
    apow = np.empty(B, dtype=np.int64)
    acc = 1
    for i in range(B):
        acc = (acc * _A) % _M
        apow[i] = acc
    jump = acc  # a^B mod m
    s = s0
    i = 0
    while i < n:
        k = min(B, n - i)
        out[i : i + k] = (apow[:k] * s) % _M
        s = (jump * s) % _M
        i += k
    return out


def minstd_uniform_stream(
    n: int, lo: float, hi: float, seed: int = 0, skip: int = 0
) -> np.ndarray:
    states = minstd_stream(n, seed, skip)
    u = (states.astype(np.float64) - 1.0) / (_M - 1)
    return (lo + u * (hi - lo)).astype(np.float32)
