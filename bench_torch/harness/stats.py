"""The arithmetic of the end-to-end metrics and of the trace's intervals."""

from __future__ import annotations

import math

# A tail needs at least this many samples for ten of them to lie beyond
# its 95th percentile.
P95_MIN_SAMPLES = 200


def step_ms(window_s: float, steps: int) -> float:
    """The window's wall time over the steps completed in it, in ms."""
    if steps <= 0:
        raise ValueError("no step completed in the window")
    return 1e3 * window_s / steps


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at least
    95% of the values do not exceed. Every value counts."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[math.ceil(0.95 * len(xs)) - 1]


def union(intervals) -> list[tuple[float, float]]:
    """Merge (start, end) intervals into disjoint ones, in order."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the union of intervals covers."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals):
        if b <= at:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out
