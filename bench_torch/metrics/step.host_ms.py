"""step.host_ms, ms: the host's time a step outside its host waits: the
median, over the traced run's unprofiled window steps, of the program's
``step`` span less the ``sync`` spans inside it (harness/program.py): the
host's work of enqueueing the step, what launch work (fusion, graphs)
shortens, and what step_ms waits on where the card is the faster side. It
carries what the traced run's profiler sessions leave behind on the host,
as every unprofiled step follows one: compare it between traced runs
only."""

from harness import program


def capture(captured):
    return program.WINDOW.capture()


def read(trace):
    return program.WINDOW.median("host_ms")
