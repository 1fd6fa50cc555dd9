"""Spans and counters inside the port's steps.

A span names a stretch of the host's work: ``step``, the root, once a call
of a step function; its stages (``advect``, ``csr``, ``p2g``, ...), with
``level_set`` and ``project`` as parents over theirs; and ``sync``, a place
where the host waits for the card. ``sync(n)`` is a span that also adds n
to the current step's ``sync`` counter, the host waits inside it. A sync is
counted where the code makes one on the card, whatever the device: the
count is the code's, the same on the CPU.

With no recording open, the default, ``span`` and ``sync`` hand back one
shared null context: no clock read, no allocation, no profiler call. Inside
``recording()`` each span keeps (name, parent, step, t0, t1) in memory,
stamped with ``time.time_ns()``, the clock on which torch.profiler stamps
its host records (launches, ``record_function`` ranges). A span can so be
set beside a device trace of the same process: a device operation belongs
to the innermost span whose [t0, t1] holds its launch. No file is written;
the caller reads the Recording.

A kernel can count on the device too: ``device_counts(names, device)``
hands it, while a recording is open, the current step's int64 counters for
those names (one small tensor a step, zero at first), and None otherwise,
so that a launch outside a recording passes a null pointer and counts
nothing. The recording adds them into ``counts[step]`` when its block
closes: one synchronize, after every step it holds.

``recording(events=device)`` also brackets each span with a pair of CUDA
events on the current stream (perf_counter stamps for a CPU device), which
give its interval on the device's timeline once the card has caught up
(``Span.ms``): the stages' times of the demo's --profile table
(utils/profiling.py).
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

STEP = "step"  # the root span of a step function's call
SYNC = "sync"  # a host wait for the card: a span and a counter


class Span(NamedTuple):
    name: str
    parent: str | None  # the enclosing span's name
    step: int | None  # index of the enclosing root step in the recording; None outside every step
    t0: int  # time.time_ns() on entry
    t1: int  # and on exit
    marks: tuple | None  # (start, end) of mark(); None without events

    def ms(self) -> float:
        """The span's interval between its marks (read after a synchronize)."""
        return elapsed_ms(*self.marks)


def mark(device: torch.device):
    """A point on the device's timeline: a CUDA event recorded on the
    current stream, or the host clock for a CPU device (which runs
    synchronously)."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def elapsed_ms(start, end) -> float:
    """ms from one mark() to a later one (CUDA: once both have completed)."""
    if isinstance(start, float):
        return 1e3 * (end - start)
    return start.elapsed_time(end)


class Recording:
    """What a ``recording()`` block took: every span, in the order they
    opened, and each step's counters ({step or None: {name: n}}), the
    device counters' among them once the block has closed."""

    def __init__(self, events: torch.device | None):
        self.events = events
        self.spans: list[Span | None] = []  # a span's slot is taken when it opens
        self.counts: dict[int | None, dict[str, int]] = {}
        self.steps = 0  # root step spans opened
        self.open: list[_Open] = []
        self.step: int | None = None  # the root step open now
        # (step, names) -> that step's device counters for those names
        self.device: dict[tuple[int | None, tuple[str, ...]], torch.Tensor] = {}

    def step_spans(self) -> list[list[Span]]:
        """Each step's spans in the order they opened, its root first."""
        out: list[list[Span]] = [[] for _ in range(self.steps)]
        for s in self.spans:
            if s is not None and s.step is not None:
                out[s.step].append(s)
        return out

    def add(self, name: str, n: int) -> None:
        row = self.counts.setdefault(self.step, {})
        row[name] = row.get(name, 0) + n

    def device_counts(self, names: tuple[str, ...], device: torch.device) -> torch.Tensor:
        key = (self.step, names)
        if key not in self.device:
            self.device[key] = torch.zeros(len(names), dtype=torch.int64, device=device)
        return self.device[key]

    def resolve(self) -> None:
        """Add the device counters into counts (one synchronize)."""
        if not self.device:
            return
        values = iter(torch.cat(list(self.device.values())).tolist())
        for step, names in self.device:
            row = self.counts.setdefault(step, {})
            for name in names:
                row[name] = row.get(name, 0) + next(values)
        self.device = {}


class _Open:
    """A span being recorded."""

    __slots__ = ("rec", "name", "parent", "step", "slot", "start", "t0", "root")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.parent = rec.open[-1].name if rec.open else None
        self.root = self.name == STEP and rec.step is None
        if self.root:
            rec.step, rec.steps = rec.steps, rec.steps + 1
        self.step = rec.step
        self.slot = len(rec.spans)
        rec.spans.append(None)
        rec.open.append(self)
        self.start = mark(rec.events) if rec.events is not None else None
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        marks = None if self.start is None else (self.start, mark(rec.events))
        rec.open.pop()
        rec.spans[self.slot] = Span(self.name, self.parent, self.step, self.t0, t1, marks)
        if self.root:
            rec.step = None
        return False


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()
_rec: Recording | None = None


def active() -> Recording | None:
    """The open recording, if any."""
    return _rec


def span(name: str):
    """A context manager: a span ``name`` while a recording is open, else NULL."""
    if _rec is None:
        return NULL
    return _Open(_rec, name)


def device_counts(names: tuple[str, ...], device: torch.device) -> torch.Tensor | None:
    """The current step's device counters for ``names`` (int64, one a name,
    in that order) while a recording is open, for a kernel to add to; None
    with no recording open."""
    if _rec is None:
        return None
    return _rec.device_counts(names, device)


def sync(n: int = 1):
    """A span around a host wait for the card; it counts n ``sync``s, the
    waits inside it."""
    if _rec is None:
        return NULL
    _rec.add(SYNC, n)
    return _Open(_rec, SYNC)


@contextlib.contextmanager
def recording(events: torch.device | None = None):
    """Record every span and counter of the block into the Recording it
    yields. ``events``: the device whose timeline each span's marks read;
    None, no marks. The device counters land in ``counts`` once the block
    has closed without an error."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already open")
    _rec = rec = Recording(events)
    try:
        yield rec
    finally:
        _rec = None
    rec.resolve()
