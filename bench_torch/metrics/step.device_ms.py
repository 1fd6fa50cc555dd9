"""step.device_ms, ms: device time a step, the union of the intervals of
the device operations the step launched."""


def read(trace):
    if not trace.steps:
        return None
    return 1e3 * trace.busy_s / len(trace.steps)
