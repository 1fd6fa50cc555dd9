"""sweeps.roofline, %: the least time of the level set's 24 sweeps
(harness/roofline.py::sweeps_work) over the device time of everything
launched inside the sweeps span."""

from harness import roofline


def read(trace):
    ms = trace.stage_ms({"sweeps"})
    if ms is None or ms <= 0:
        return None
    sc = trace.scene
    least = roofline.least_s(*roofline.sweeps_work(sc["nx"] * sc["ny"] * sc["nz"]))
    return 100.0 * 1e3 * least / ms
