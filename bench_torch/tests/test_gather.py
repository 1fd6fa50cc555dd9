"""The RK3 gathers' readers (metrics/stage.gather_ms.py, gather.roofline.py):
the work function against a count by hand, capture() summing a step's
calls from their arguments, and both readers on made-up traces, with and
without an operation launched inside a gather span. On the card (skipped
without one): under the flip_gather table the program's gather spans, and
its advect, p2g, sweeps and sor spans, label the very operations the
benchmark's own spans of those names do, as test_program.py shows under
the flip and apic tables."""

import pytest
import torch
from test_program import dev, labels  # noqa: F401  (dev: a fixture)
from test_trace import CPU, GPU, Ev, one_iteration, trace_of

import run
from harness import catalog, roofline, tracing

from fluidsimulation_tpu_torch.utils import trace

READERS = ("stage.gather_ms", "gather.roofline")


def test_gather_work_is_the_count_by_hand():
    work = catalog.metric_reader("gather.roofline").gather_work
    # 5 positions on a 2 x 3 x 4 grid: faces 3*3*4 + 2*4*4 + 2*3*5 = 98.
    assert roofline.faces(2, 3, 4) == 98
    assert work(5, 98) == (12 * 5 + 12 * 5 + 4 * 98, 7 * 3 * 3 * 5) == (512, 315)
    # The 256^3 cell: 65,548,256 positions, 1.775 GB, 0.530 ms a gather (bytes bound).
    nbytes, ops = work(65_548_256, roofline.faces(256, 256, 256))
    assert nbytes == 1_775_271_168
    assert roofline.least_s(nbytes, ops) == pytest.approx(0.52993e-3, rel=1e-4)
    assert nbytes / roofline.HBM_BYTES_PER_S > ops / roofline.FP32_FLOP_PER_S


def test_capture_sums_the_calls_of_a_step():
    reader = catalog.metric_reader("gather.roofline")
    u, v, w = torch.zeros(3, 3, 4), torch.zeros(2, 4, 4), torch.zeros(2, 3, 5)
    call = (u, v, w, torch.zeros(5, 3))
    got = reader.capture({"gather": [call, call]})
    assert got["gather_least_s"] == pytest.approx(2 * roofline.least_s(512, 315))
    assert reader.capture({}) is None and reader.capture({"gather": [(u, v)]}) is None


def test_readers_read_nothing_without_a_gather_op():
    trace = trace_of(one_iteration(0, 0))  # advect and sor spans only
    assert all(catalog.metric_reader(n).read(trace) is None for n in READERS)


def test_readers_on_a_made_up_trace_with_gathers():
    """Two gathers inside advect (20 us and 10 us on the card) and one
    advect kernel outside them: stage.gather_ms holds the two alone."""
    events = [
        Ev("bench::iter", CPU, 0, 100, 1),
        Ev("bench::advect", CPU, 1, 60, 2),
        Ev("bench::gather", CPU, 2, 10, 3), Ev("cudaLaunchKernel", CPU, 3, 1, 10),
        Ev("k_g1", GPU, 10, 20, 10),
        Ev("bench::gather", CPU, 20, 10, 4), Ev("cudaLaunchKernel", CPU, 21, 1, 11),
        Ev("k_g2", GPU, 30, 10, 11),
        Ev("cudaLaunchKernel", CPU, 40, 1, 12), Ev("k_clamp", GPU, 45, 5, 12),
    ]
    trace = trace_of(events)
    trace.steps[0].facts["gather_least_s"] = 6e-6
    assert [(o.name, o.label) for o in trace.steps[0].ops] == [
        ("k_g1", "gather"), ("k_g2", "gather"), ("k_clamp", "advect")]
    ms = catalog.metric_reader("stage.gather_ms").read(trace)
    assert ms == pytest.approx(0.030)
    assert catalog.metric_reader("gather.roofline").read(trace) == pytest.approx(20.0)


# --- on the card -----------------------------------------------------------

def test_gather_spans_label_the_operations_as_the_bench_spans_do(dev):
    """One profiled FLIP step of the demo under the flip_gather table (after
    a profiled one dropped, as a stretch does): no operation lost its launch
    record or launched outside every program span, the gathers' operations
    are those under the bench::gather span, and advect's (its gathers
    included) are those under bench::advect and bench::gather together, as
    an operation takes its innermost span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    conf = catalog.config("demo64")
    entries = conf["program"]["transfers"]["flip"]
    cfg = run.resolve(conf["program"]["config"])(**conf["scene"], seed=2**31 + 13)
    init, step = run.resolve(entries["init"]), run.resolve(entries["step"])
    s = init(cfg, dev)
    for _ in range(2):
        s = step(s, 1.0 / 120.0, cfg)
    torch.cuda.synchronize()
    with tracing.spans(conf["program"]["package"], catalog.sites("flip_gather")):
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
    under = {"advect": {"advect", "gather"}}
    for name in ("gather", "advect", "p2g", "sweeps", "sor"):
        bench = sorted((o.name, o.start) for o in ops if o.label in under.get(name, {name}))
        prog = sorted(k for k, chain in chains.items() if name in chain)
        assert bench and bench == prog, name
