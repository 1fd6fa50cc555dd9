"""device.idle, %: the share of the traced steps' wall time (step call to
the end of the synchronize after it) in which no device operation was in
flight, from the union of the device intervals in one trace."""


def read(trace):
    if not trace.steps or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
