"""The program's spans read beside the trace (harness/program.py): the
program spans holding an operation's launch label it, innermost first
(``labels``, here until the trace's parse gives operations their program
label); the three
readers of the program's records (step.host_ms, step.sync_wait_ms,
step.host_syncs) read medians over the unprofiled steps only; the traced
run's Tracer opens the recording at the window's first profiled step and
marks the profiled ones; a --trace 0 run never opens it. On the card
(skipped without one): every device operation a step launches carries a
program span, and the spans advect, p2g, sweeps and sor label the very
operations the benchmark's own spans of those names do."""

import contextlib
import io
import json

import pytest
import torch
from test_trace import CPU, GPU, Ev

import run
from harness import catalog, program, tracing

from fluidsimulation_tpu_torch.utils import trace

READERS = ("step.host_ms", "step.sync_wait_ms", "step.host_syncs")


@pytest.fixture
def window(monkeypatch):
    """A fresh WINDOW for the test, its recording closed after it."""
    w = program.Window()
    monkeypatch.setattr(program, "WINDOW", w)
    yield w
    w.steps()
    assert trace.active() is None


def span(name, parent, step, t0_us, t1_us):
    return trace.Span(name, parent, step, int(t0_us * 1000), int(t1_us * 1000), None)


def labels(events, spans) -> dict[tuple[str, float], tuple[str, ...]]:
    """(name, device start in s, as tracing.parse gives them) of each device
    operation in a profiler's events -> the names of the program spans
    holding its launch, innermost first; () with no such span or no launch
    record. The spans are stamped with time.time_ns(), the clock of the
    profiler's host records."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    mirrors = {(e.name(), e.correlation_id()) for e in cpu}
    launches = {e.correlation_id(): e.start_ns() for e in cpu if e.name().startswith("cu")}
    out = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA or (e.name(), e.correlation_id()) in mirrors:
            continue
        at = launches.get(e.correlation_id())
        held = [] if at is None else sorted((s.t1 - s.t0, s.name) for s in spans
                                            if s.t0 <= at <= s.t1)
        out[(e.name(), 1e-9 * e.start_ns())] = tuple(name for _, name in held)
    return out


def test_an_operation_takes_the_program_spans_holding_its_launch_innermost_first():
    events = [
        Ev("cudaLaunchKernel", CPU, 12, 1, 100), Ev("k_a", GPU, 20, 10, 100),
        Ev("cudaLaunchKernel", CPU, 31, 1, 101), Ev("k_b", GPU, 40, 10, 101),
        Ev("cudaMemcpyAsync", CPU, 55, 1, 102), Ev("copy", GPU, 60, 2, 102),
        Ev("cudaLaunchKernel", CPU, 95, 1, 103), Ev("k_c", GPU, 96, 2, 103),
        Ev("bench::sor", CPU, 30, 5, 7), Ev("bench::sor", GPU, 40, 10, 7),  # a mirror
        Ev("k_lost", GPU, 70, 1, 999),  # no launch record
    ]
    spans = [span("step", None, 0, 10, 90), span("project", "step", 0, 25, 50),
             span("sor", "project", 0, 30, 35), span("advect", "step", 0, 11, 20)]
    got = {name: chain for (name, _), chain in labels(events, spans).items()}
    assert got == {"k_a": ("advect", "step"), "k_b": ("sor", "project", "step"),
                   "copy": ("step",), "k_c": (), "k_lost": ()}
    assert ("k_a", 1e-9 * events[1].start_ns()) in labels(events, spans)


def made_up(window, profiled):
    """Four steps of 10 ms (the profiled ones 30 ms), each with two sync
    spans: 1 + i ms and 0.5 ms, and the sync counter at 3."""
    rec = trace.Recording(None)
    t = 0
    for i in range(4):
        length = 30_000 if i in profiled else 10_000
        rec.spans += [span("step", None, i, t, t + length),
                      span("csr", "step", i, t + 100, t + 3_000),
                      span("sync", "csr", i, t + 200, t + 1_200 + 1_000 * i),
                      span("sync", "sort", i, t + 5_000, t + 5_500)]
        rec.counts[i] = {"sync": 3}
        t += length
    rec.steps = 4
    window.rec, window.profiled = rec, set(profiled)


def test_the_readers_take_medians_over_the_unprofiled_steps(window):
    made_up(window, profiled={1, 2})
    readers = {n: catalog.metric_reader(n) for n in READERS}
    got = {n: r.read(None) for n, r in readers.items()}
    # Steps 0 and 3: waits 1.5 and 4.5 ms of 10 ms.
    assert got["step.sync_wait_ms"] == pytest.approx(3.0)
    assert got["step.host_ms"] == pytest.approx(7.0)
    assert got["step.host_syncs"] == 3


def test_no_recording_reads_nothing(window, monkeypatch):
    monkeypatch.setattr(program, "TRACE", "no_such_package.utils.trace")
    window.capture()
    window.capture()
    assert window.rec is None
    assert all(catalog.metric_reader(n).read(None) is None for n in READERS)


def test_the_tracer_opens_the_recording_and_marks_its_profiled_steps(window, monkeypatch):
    """The window's first step is a stretch's first, profiled; the readers'
    capture() runs after each profiled step (three readers, three calls)."""
    import types

    import torch.profiler

    class Session:
        profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: []))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Session())
    monkeypatch.setattr(tracing, "parse",
                        lambda events: [(0.0, 1.0, [])] * (1 + tracing.STRETCH_STEPS))
    readers = [catalog.metric_reader(n) for n in READERS]
    tracer = tracing.Tracer(10.0, tracing.Captures(), [r.capture for r in readers])

    def step():
        with trace.span("step"):
            with trace.sync():
                pass

    def iteration(span=None):
        with (span or contextlib.nullcontext)():
            step()

    tracer.stretch(iteration)  # the window's first stretch opens the recording
    assert trace.active() is window.rec
    for _ in range(5):
        iteration()
    tracer.stretch(iteration)
    rec = window.rec
    # Recorded: the first stretch's 3 later steps, 5 unprofiled, the second stretch's 4.
    assert rec.steps == 3 + 5 + 4
    assert window.profiled == {0, 1, 2, 8, 9, 10, 11}
    assert [r.read(None) for r in readers][2] == 1
    assert len(window.steps()) == 5 and trace.active() is None


def test_a_trace_0_run_leaves_the_recording_off(window, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a --trace 0 run opened the program's recording")

    monkeypatch.setattr(trace, "recording", refuse)
    conf = catalog.config("demo64")
    conf["scene"].update(nx=12, ny=12, nz=12, cells_per_meter=12.0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", "demo64.flip", "--seed", str(2**31 + 9), "--seconds", "0.5",
                       "--trace", "0"], dev=torch.device("cpu"), conf=conf)
    assert rc == 0 and json.loads(out.getvalue().strip().splitlines()[-1])["attempted"] > 0
    assert window.rec is None and trace.active() is None


# --- on the card -----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_program_spans_label_the_operations_as_the_bench_spans_do(dev, transfer):
    """One profiled step of the demo (after a profiled one dropped, as a
    stretch does): no operation lost its launch record or launched outside
    every program span, and for advect, p2g, sweeps and sor the operations
    under the program span (a sync span inside it included) are those
    under the bench:: span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    conf = catalog.config("demo64")
    entries = conf["program"]["transfers"][transfer]
    cfg = run.resolve(conf["program"]["config"])(**conf["scene"], seed=2**31 + 11)
    init, step = run.resolve(entries["init"]), run.resolve(entries["step"])
    s = init(cfg, dev)
    for _ in range(2):
        s = step(s, 1.0 / 120.0, cfg)
    torch.cuda.synchronize()
    with tracing.spans(conf["program"]["package"], catalog.sites(entries["sites"])):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with trace.recording() as rec:
                for _ in range(2):
                    with record_function(tracing.PREFIX + tracing.ITER):
                        s = step(s, 1.0 / 120.0, cfg)
                        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    *_, (_, _, ops) = tracing.parse(events)
    held = labels(events, [x for x in rec.spans if x.step == 1])
    assert ops and all(o.label != tracing.LOST for o in ops)
    chains = {(o.name, o.start): held[(o.name, o.start)] for o in ops}
    assert all(chain[-1] == "step" for chain in chains.values())
    for name in ("advect", "p2g", "sweeps", "sor"):
        bench = sorted((o.name, o.start) for o in ops if o.label == name)
        prog = sorted(k for k, chain in chains.items() if name in chain)
        assert bench and bench == prog, name
