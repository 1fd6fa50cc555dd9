"""step.launches, launches/step: device operations (kernels, copies,
fills) a step, from the trace: each is one launch by the host."""


def read(trace):
    if not trace.steps:
        return None
    return sum(len(s.ops) for s in trace.steps) / len(trace.steps)
