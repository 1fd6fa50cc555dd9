"""Spans around the program's stage calls, and the device trace of short
stretches of the window read into per-step records.

The spans are the benchmark's own: while ``spans`` is open, every call of a
site (module, function, label) of the site table runs inside
``torch.profiler.record_function("bench::<label>")``, hooked where the
program's code looks the function up. A site the program no longer has is
skipped, and the metrics that read its label find nothing.

A traced run profiles a few stretches of ``STRETCH_STEPS`` steps spread over
the window (``Tracer``), each after one more step that is profiled and
dropped: the profiler loses a few records at the start of each session
(none to a hundred, more in each later session, all in its first step).
Each traced step is one iteration of the loop, the step call and the
synchronize after it, inside a ``bench::iter`` span. The device operations
(kernels, copies, fills) come from the profiler's records and are given to
a step and a span through the host call that launched them (the CUDA
runtime record that shares the operation's correlation id): a launch made
while the host was inside a span belongs to it. A stretch in which a step
holds another number of device operations than the traced steps' most
common count, or an operation whose launch record was lost, is dropped,
and another stretch is profiled in its place, at once where the slots left
could not make up the number. A trace with fewer than ``STRETCHES`` clean
stretches is not whole, and the run reports no per-layer metric from it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib
import sys

from . import stats

STRETCH_STEPS = 3  # steps a stretch
STRETCHES = 8  # clean stretches a whole trace holds, one at each of as many slots
RETRIES = 8  # stretches that may be profiled beyond STRETCHES, for dropped ones
ITER = "iter"
PREFIX = "bench::"
LOST = "lost"  # the label of a device op whose launch record the profiler lost


class Captures(dict):
    """label -> the positional arguments of each call of its site, taken
    while ``active`` (during a traced step)."""

    active = False


@contextlib.contextmanager
def spans(package: str, sites, captured: Captures | None = None):
    """While open, each call of a site runs inside its span, and, while
    ``captured`` is active, its positional arguments are appended to
    captured[label]."""
    from torch.profiler import record_function

    saved = []
    for mod_name, attr, label in sites:
        try:
            module = importlib.import_module(f"{package}.{mod_name}")
            orig = getattr(module, attr)
        except (ImportError, AttributeError):
            print(f"trace: site {mod_name}.{attr} not found; {label!r} reads nothing",
                  file=sys.stderr)
            continue

        def hook(*args, _orig=orig, _label=label, **kwargs):
            if captured is not None and captured.active:
                captured.setdefault(_label, []).append(args)
            with record_function(PREFIX + _label):
                return _orig(*args, **kwargs)

        functools.update_wrapper(hook, orig)
        saved.append((module, attr, orig))
        setattr(module, attr, hook)
    try:
        yield
    finally:
        for module, attr, orig in reversed(saved):
            setattr(module, attr, orig)


@dataclasses.dataclass
class Op:
    name: str
    start: float  # device interval, s on the profiler's clock
    end: float
    label: str | None  # the span its launch was made in


@dataclasses.dataclass
class Step:
    start: float  # the bench::iter span: step call to the end of the synchronize
    end: float
    ops: list[Op]
    facts: dict  # what the metric readers' capture() took from the stage inputs


@dataclasses.dataclass
class Trace:
    """The kept traced steps, and what the metric readers need beside them."""

    steps: list[Step]
    scene: dict
    transfer: str
    dropped: int  # stretches dropped for lost records
    whole: bool = True  # STRETCHES clean stretches were kept

    @property
    def window_s(self) -> float:
        return sum(s.end - s.start for s in self.steps)

    @property
    def busy_s(self) -> float:
        return sum(stats.covered([(o.start, o.end) for o in s.ops], s.start, s.end)
                   for s in self.steps)

    def stage_ms(self, labels) -> float | None:
        """Device ms a step of the operations launched inside the spans of
        ``labels``; None when no traced step launched any there."""
        per_step, found = [], False
        for s in self.steps:
            ivs = [(o.start, o.end) for o in s.ops if o.label in labels]
            found = found or bool(ivs)
            per_step.append(stats.covered(ivs, s.start, s.end))
        if not found:
            return None
        return 1e3 * sum(per_step) / len(per_step)

    def facts(self, key: str) -> list:
        """Each traced step's fact ``key``, where it has one."""
        return [s.facts[key] for s in self.steps if key in s.facts]

    def device_ops(self, top: int = 10) -> list[list]:
        """[name, seconds] of the device operations that took most time."""
        total: dict[str, float] = {}
        for s in self.steps:
            for o in s.ops:
                total[o.name] = total.get(o.name, 0.0) + (o.end - o.start)
        return [[n[:160], t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """[label, seconds] of the device's idle time inside the traced
        steps, by the span the host was in when it launched the operation
        that ended the gap ("sync" for the wait at a step's end, "step" for
        host code of the step outside every stage span)."""
        total: dict[str, float] = {}
        for s in self.steps:
            ops = sorted(s.ops, key=lambda o: o.start)
            starts = [o.start for o in ops]
            for a, b in stats.gaps([(o.start, o.end) for o in ops], s.start, s.end):
                i = bisect.bisect_left(starts, b)
                label = (ops[i].label or "step") if i < len(ops) else "sync"
                total[label] = total.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def parse(events) -> list[tuple[float, float, list[Op]]]:
    """The iterations of one profiled stretch, from the profiler's events:
    [(iter start, iter end, device ops launched inside it)], in s. An op
    whose launch record is missing is given its device start as the launch
    time and the label LOST."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    # A span's device-side range repeats the span's own name and id.
    mirrors = {(e.name(), e.correlation_id()) for e in cpu}
    launches = {e.correlation_id(): e.start_ns() for e in cpu if e.name().startswith("cu")}
    spans_ = [(e.name()[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
              for e in cpu if e.name().startswith(PREFIX)]
    iters = sorted((a, b) for lab, a, b in spans_ if lab == ITER)
    stages = [(lab, a, b) for lab, a, b in spans_ if lab != ITER]
    out = [(a, b, []) for a, b in iters]
    for e in dev:
        if (e.name(), e.correlation_id()) in mirrors:
            continue
        start = e.start_ns()
        at = launches.get(e.correlation_id())
        if at is None:
            at, label = start, LOST
        else:
            label = min(((b - a, lab) for lab, a, b in stages if a <= at <= b),
                        default=(0, None))[1]
        for a, b, ops in out:
            if a <= at <= b:
                ops.append(Op(e.name(), 1e-9 * start, 1e-9 * (start + e.duration_ns()), label))
                break
    return [(1e-9 * a, 1e-9 * b, ops) for a, b, ops in out]


class Tracer:
    """Profiles STRETCH_STEPS-step stretches at STRETCHES evenly spaced
    times of the window, and more in place of dropped ones, until STRETCHES
    are kept or STRETCHES + RETRIES have been profiled."""

    def __init__(self, seconds: float, captures: Captures, readers_capture: list):
        self.slots = [seconds * j / STRETCHES for j in range(STRETCHES)]
        self.stretches: list[list[Step]] = []
        self.captured = captures
        self.capture_fns = readers_capture

    def due(self, elapsed: float) -> bool:
        kept = len(self._kept())
        if kept >= STRETCHES or len(self.stretches) >= STRETCHES + RETRIES:
            return False
        if self.slots and elapsed >= self.slots[0]:
            while self.slots and elapsed >= self.slots[0]:
                self.slots.pop(0)
            return True
        return kept + len(self.slots) < STRETCHES

    def stretch(self, iteration) -> None:
        """Profile 1 + STRETCH_STEPS iterations of the loop and keep the
        last STRETCH_STEPS: ``iteration(span)`` runs one, its step and
        synchronize inside ``span()``."""
        from torch.profiler import ProfilerActivity, profile

        facts = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(1 + STRETCH_STEPS):
                iteration(self._span)
                facts.append(self._facts())
                self.captured.clear()
        steps = [Step(a, b, ops, f) for (a, b, ops), f in
                 zip(parse(prof.profiler.kineto_results.events()), facts)]
        self.stretches.append(steps[1:])  # the session's first step is its warm-up

    @contextlib.contextmanager
    def _span(self):
        from torch.profiler import record_function

        self.captured.clear()
        self.captured.active = True
        try:
            with record_function(PREFIX + ITER):
                yield
        finally:
            self.captured.active = False

    def _facts(self) -> dict:
        out = {}
        for fn in self.capture_fns:
            out.update(fn(self.captured) or {})
        return out

    def _kept(self) -> list[list[Step]]:
        """The stretches whose every step holds the usual number of device
        operations (the most common count over all traced steps), none of
        them without its launch record."""
        counts = [len(s.ops) for st in self.stretches for s in st]
        usual = max(set(counts), key=counts.count) if counts else 0
        return [st for st in self.stretches
                if len(st) == STRETCH_STEPS
                and all(len(s.ops) == usual and all(o.label != LOST for o in s.ops) for s in st)]

    def summary(self) -> str:
        """Each stretch's device operations a step, and those without a
        launch record, for the run's log."""
        return "; ".join(
            "/".join(str(len(s.ops)) for s in st)
            + (f" ({sum(o.label == LOST for s in st for o in s.ops)} unlaunched)"
               if any(o.label == LOST for s in st for o in s.ops) else "")
            for st in self.stretches)

    def trace(self, scene: dict, transfer: str) -> Trace:
        kept = self._kept()
        return Trace([s for st in kept for s in st], scene, transfer,
                     dropped=len(self.stretches) - len(kept), whole=len(kept) >= STRETCHES)
