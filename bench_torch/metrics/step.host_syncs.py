"""step.host_syncs, syncs/step: the program's ``sync`` counter inside its
``step`` span, the host waits for the card a step, averaged over the traced
run's unprofiled window steps (harness/program.py). A count: the same in
every run of a cell."""

import statistics

from harness import program


def capture(captured):
    return program.WINDOW.capture()


def read(trace):
    steps = program.WINDOW.steps()
    return statistics.fmean(s.syncs for s in steps) if steps else None
