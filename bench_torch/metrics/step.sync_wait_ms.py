"""step.sync_wait_ms, ms: the host's time a step inside the program's
``sync`` spans, where it waits for the card to drain its queue: the median
over the traced run's unprofiled window steps (harness/program.py). Every
launch after such a wait finds the card idle."""

from harness import program


def capture(captured):
    return program.WINDOW.capture()


def read(trace):
    return program.WINDOW.median("sync_wait_ms")
