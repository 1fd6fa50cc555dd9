"""The program's own spans and counters (the port's utils/trace.py), read
beside the benchmark's device trace.

The readers of step.host_ms, step.sync_wait_ms and step.host_syncs share
WINDOW. A traced run's Tracer calls their capture() after each profiled
step of the window. The first call opens the program's recording, right
after the window's first step (the first stretch starts with it); each
later call marks the step just run as profiled. The recording stays open
to the window's end, and the first read() closes it. The window's other
steps are the unprofiled ones: no profiler session is open around them. A
``--trace 0`` run loads no reader, so the program's recording stays off. A
program without utils/trace.py gives no recording, and the readers read
nothing.

``step.host_ms`` is the host's time a step with no profiler session open
around the step, not with no profiler at all: every unprofiled step runs
after the first profiled stretch, so it carries what a profiler session
leaves behind on the host. The opening and closing by the readers'
capture() and read() stands in for the run opening the recording for its
window.
"""

from __future__ import annotations

import importlib
import statistics
from typing import NamedTuple

TRACE = "fluidsimulation_tpu_torch.utils.trace"
STEP, SYNC = "step", "sync"


class StepTimes(NamedTuple):
    host_ms: float  # the step span less the sync spans inside it
    sync_wait_ms: float  # the sync spans inside the step span
    syncs: int  # the step's sync counter


def step_times(rec, profiled: set[int]) -> list[StepTimes]:
    """Each step of the recording that was not profiled, in order."""
    out = []
    for i, spans in enumerate(rec.step_spans()):
        if i in profiled or not spans:
            continue
        root = spans[0]
        wait = sum(s.t1 - s.t0 for s in spans if s.name == SYNC)
        out.append(StepTimes(1e-6 * (root.t1 - root.t0 - wait), 1e-6 * wait,
                             rec.counts.get(i, {}).get(SYNC, 0)))
    return out


class Window:
    """The program's recording over a traced run's window."""

    def __init__(self):
        self.rec = None
        self.profiled: set[int] = set()
        self._open = None  # the recording's context manager while it is open
        self._steps: list[StepTimes] | None = None
        self._missing = False  # the program has no utils/trace.py

    def capture(self) -> None:
        """After a profiled step: open the recording, or mark the step."""
        if self._steps is not None or self._missing:
            return None
        if self._open is None:
            try:
                trace = importlib.import_module(TRACE)
            except ImportError:
                self._missing = True
                return None
            self._open = trace.recording()
            self.rec = self._open.__enter__()
        elif self.rec.steps:
            self.profiled.add(self.rec.steps - 1)
        return None

    def steps(self) -> list[StepTimes]:
        """The unprofiled steps' times; the first call closes the recording."""
        if self._steps is None:
            if self._open is not None:
                self._open.__exit__(None, None, None)
                self._open = None
            self._steps = [] if self.rec is None else step_times(self.rec, self.profiled)
        return self._steps

    def median(self, field: str) -> float | None:
        values = [getattr(s, field) for s in self.steps()]
        return statistics.median(values) if values else None


WINDOW = Window()

