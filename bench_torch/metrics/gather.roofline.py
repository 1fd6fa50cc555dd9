"""gather.roofline, %: the least time of the RK3 advection's grid gathers
over the device time of everything launched inside the gather spans
(stage.gather_ms). The least time of a call is the larger of its bytes over
the memory rate and its float32 operations over the peak rate
(harness/roofline.py's peaks), summed over the calls of a step."""

from harness import roofline


def gather_work(n: int, nfaces: int) -> tuple[int, int]:
    """interp_mac3_vec(u, v, w, pos_cells) at n positions: the positions
    read (12 B each), the velocities written (12 B each), each face of u, v
    and w read once (4 B); a trilinear blend of 7 lerps of 3 operations for
    each of the 3 components, 63 operations a position, a lower bound (the
    axis splits and clamps are not counted)."""
    return 12 * n + 12 * n + 4 * nfaces, 63 * n


def capture(captured):
    calls = [args for args in captured.get("gather", ()) if len(args) == 4]
    if not calls:
        return None
    least = sum(roofline.least_s(*gather_work(pc.numel() // 3,
                                              u.numel() + v.numel() + w.numel()))
                for u, v, w, pc in calls)
    return {"gather_least_s": least}


def read(trace):
    ms = trace.stage_ms({"gather"})
    least = trace.facts("gather_least_s")
    if ms is None or not least or ms <= 0:
        return None
    return 100.0 * 1e3 * (sum(least) / len(least)) / ms
