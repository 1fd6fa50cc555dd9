"""The port's spans and counters (utils/trace.py) on the CPU: off by
default, with one shared null context and nothing recorded; on, each span
with its parent and step, stamped on the clock torch.profiler stamps its
host records with; the per-step sync counter; the spans each of the four step
functions emits, in step order under one ``step`` root, the RK3 gathers'
among them; and the same state, bit for bit, with tracing on and off.

Marked ``cuda`` (skipped without a card): one step of each 3D family at the
demo's size makes as many host syncs as ``set_sync_debug_mode("warn")``
warns of, and a step at 32^3 (32^2) with recording on gives the state it
gives with recording off, FLIP's bit for bit."""

import time
import warnings

import pytest
import torch

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.ops import advect
from fluidsimulation_tpu_torch.utils import trace
from fluidsimulation_tpu_torch.utils.metrics import check_state

N = 12
CFG = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N))
CFG2D = ft.SimConfig2D(nx=N, ny=N, cells_per_meter=float(N))
DT = 0.01

# (span, parent) in the order each family's step opens them. Each sync
# span is a host wait on the card: the copy of the cell scale
# (ops/common.py::cell_scale, solver/step2d.py::_scale) and the CSR build's
# bincount, which counts 2. The 3D advection's grid gathers are each a
# gather span inside advect (ops/advect.py): two a step, as both 3D
# families give RK3 its first stage (FLIP's carried k1, APIC's velocity).
PARENT = {"step": None, "seed": "level_set", "pass": "level_set", "sweeps": "level_set",
          "rhs": "project", "diag": "project", "sor": "project", "apply": "project",
          "gather": "advect"}


def spans(*names):
    """(name, parent) of each span, in step order: a sync's parent is the
    stage opened before it, any other's PARENT's entry, else the step."""
    out = []
    for name in names:
        if name == "sync":
            out.append((name, next(n for n, _ in reversed(out) if n != "sync")))
        else:
            out.append((name, PARENT.get(name, "step")))
    return out


LEVEL_SET_3D = ("level_set", "seed", "pass", "sweeps")
PROJECT = ("project", "rhs", "diag", "sor", "apply")
FIRST_3D = ("step", "advect", "sync", "gather", "gather", "csr", "sync", "sync", "sort", "sync",
            *LEVEL_SET_3D)
SPANS_FLIP = spans(*FIRST_3D, "p2g", "extrapolate", "gravity", *PROJECT, "particle_update",
                   "blur")
SPANS_APIC = spans(*FIRST_3D, "p2g", "sync", "extrapolate", "gravity", *PROJECT,
                   "particle_update", "sync", "sync", "sync", "sync", "blur")
SPANS_FLIP2D = spans("step", "advect", "sync", "level_set", "seed", "sync", "sweeps", "p2g", "sync",
                     "extrapolate", "gravity", *PROJECT, "particle_update")
SPANS_APIC2D = spans("step", "advect", "sync", "level_set", "seed", "sync", "sweeps", "p2g", "sync",
                     "sync", "sync", "extrapolate", "gravity", *PROJECT, "particle_update", "sync",
                     "sync", "sync")

FAMILIES = {  # init, step, config, fields, spans, syncs a step
    "flip": (ft.init_state, ft.step, CFG, ("pos", "vel", "u", "v", "w", "phi", "k1"), SPANS_FLIP,
             5),
    "apic": (ft.init_apic_state, ft.step_apic, CFG, ("pos", "vel", "C", "u", "v", "w", "phi"),
             SPANS_APIC, 10),
    "flip2d": (ft.init_state2d, ft.step2d, CFG2D, ("pos", "vel", "u", "v", "phi"), SPANS_FLIP2D,
               3),
    "apic2d": (ft.init_apic_state2d, ft.step_apic2d, CFG2D, ("pos", "vel", "C", "u", "v", "phi"),
               SPANS_APIC2D, 8),
}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_off_records_nothing_and_hands_back_the_null():
    assert trace.active() is None
    assert trace.span("advect") is trace.NULL and trace.span("step") is trace.NULL
    assert trace.sync() is trace.NULL
    with trace.span("step") as opened, trace.sync(2) as waited:
        assert opened is None and waited is None
    ft.step(ft.init_state(CFG, "cpu"), DT, CFG)
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {} and rec.steps == 0
    assert trace.active() is None


def test_nesting_gives_each_span_its_parent_and_step():
    with trace.recording() as rec:
        assert trace.active() is rec
        with trace.span("outside"):
            pass
        for _ in range(2):
            with trace.span("step"):
                with trace.span("a"):
                    with trace.span("b"):
                        pass
                    with trace.span("step"):  # inside a step: a child, not a new step
                        pass
    assert trace.active() is None
    got = [(s.name, s.parent, s.step) for s in rec.spans]
    assert got == [("outside", None, None),
                   ("step", None, 0), ("a", "step", 0), ("b", "a", 0), ("step", "a", 0),
                   ("step", None, 1), ("a", "step", 1), ("b", "a", 1), ("step", "a", 1)]
    assert rec.steps == 2
    assert [[s.name for s in step] for step in rec.step_spans()] == [["step", "a", "b", "step"]] * 2
    for outer, inner in ((rec.spans[1], rec.spans[2]), (rec.spans[2], rec.spans[3])):
        assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert all(s.marks is None for s in rec.spans)


def test_a_second_recording_is_refused():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass
    assert trace.active() is None


def test_stamps_are_time_ns_inside_a_record_function_around_them():
    """A span opened inside a record_function range lies inside that range
    as torch.profiler stamps it: both are on time.time_ns()'s clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            with record_function("outer"):
                before = time.time_ns()
                with trace.span("inner"):
                    time.sleep(0.002)
                after = time.time_ns()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer"]
    (inner,) = rec.spans
    end = ev.start_ns() + ev.duration_ns()
    assert ev.start_ns() <= before <= inner.t0 < inner.t1 <= after <= end
    assert inner.t1 - inner.t0 >= 2_000_000


def test_count_and_sync_tally_per_step():
    """Each sync span adds its count of waits to the step it is in; one
    outside every step, to no step (None)."""
    with trace.recording() as rec:
        with trace.sync():
            pass
        for n in (1, 3):
            with trace.span("step"):
                for _ in range(n):
                    with trace.sync(2):
                        pass
    assert rec.counts == {None: {"sync": 1}, 0: {"sync": 2}, 1: {"sync": 6}}
    assert [s.name for s in rec.step_spans()[1]] == ["step", "sync", "sync", "sync"]
    assert [(s.name, s.step) for s in rec.spans[:1]] == [("sync", None)]


def test_device_counts_land_in_their_steps_when_the_block_closes():
    """A kernel's device counters: None with no recording open (its launch
    passes a null pointer); inside one, one tensor a step and set of names,
    zero at first, whose values the recording adds into counts[step] beside
    the sync counter once the block has closed, and not before."""
    cpu, names = torch.device("cpu"), ("k.visits", "k.steps")
    assert trace.device_counts(names, cpu) is None
    with trace.recording() as rec:
        trace.device_counts(names, cpu)[0] += 4  # outside every step
        with trace.span("step"):
            counts = trace.device_counts(names, cpu)
            assert counts.dtype == torch.int64 and counts.tolist() == [0, 0]
            counts += torch.tensor([3, 5])
            assert trace.device_counts(names, cpu) is counts
            with trace.sync(2):
                pass
        with trace.span("step"):
            trace.device_counts(names, cpu)[1] += 7
        assert rec.counts == {0: {"sync": 2}}
    assert rec.counts == {None: {"k.visits": 4, "k.steps": 0},
                          0: {"sync": 2, "k.visits": 3, "k.steps": 5},
                          1: {"k.visits": 0, "k.steps": 7}}
    assert trace.device_counts(names, cpu) is None


def test_the_plain_p2g_counts_nothing():
    """On the CPU P2G takes its plain scatter form: no kernel, no device
    counter, even with a recording open."""
    from fluidsimulation_tpu_torch.ops import cuda_p2g
    from fluidsimulation_tpu_torch.ops.binning import build_csr

    s = ft.init_state(CFG, "cpu")
    csr = build_csr(CFG, s.pos)
    pcs, vels = (s.pos * N)[csr.order], s.vel[csr.order]
    with trace.recording() as rec:
        with trace.span("step"):
            got = cuda_p2g.p2g_accumulate(CFG, pcs, vels, csr.start)
    assert rec.counts == {} and rec.device == {}
    want = cuda_p2g.p2g_accumulate_plain(CFG, pcs, vels)
    assert all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))


def test_events_mark_each_span_on_the_device_timeline():
    """With events on a CPU device the marks are host clock stamps, and a
    child's interval lies inside its parent's."""
    with trace.recording(events=torch.device("cpu")) as rec:
        with trace.span("step"):
            with trace.span("a"):
                time.sleep(0.002)
    outer, inner = rec.spans
    assert outer.marks[0] <= inner.marks[0] < inner.marks[1] <= outer.marks[1]
    assert outer.ms() >= inner.ms() >= 2.0
    assert trace.elapsed_ms(1.0, 1.5) == 500.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_each_step_emits_its_spans_in_step_order(family):
    init, step, cfg, _, expect, syncs = FAMILIES[family]
    s0 = init(cfg, "cpu")
    with trace.recording() as rec:
        step(step(s0, DT, cfg), DT, cfg)
    assert rec.steps == 2
    for i, got in enumerate(rec.step_spans()):
        assert [(s.name, s.parent) for s in got] == expect
        assert all(s.step == i for s in got)
        root = got[0]
        assert all(root.t0 <= s.t0 <= s.t1 <= root.t1 for s in got)
    assert rec.counts == {0: {"sync": syncs}, 1: {"sync": syncs}}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_state_is_bit_equal_with_tracing_on_and_off(family):
    init, step, cfg, fields, _, _ = FAMILIES[family]
    s0 = init(cfg, "cpu")
    off = step(step(s0, DT, cfg), DT, cfg)
    with trace.recording(events=torch.device("cpu")):
        on = step(step(s0, DT, cfg), DT, cfg)
    for name in fields:
        torch.testing.assert_close(getattr(on, name), getattr(off, name), rtol=0, atol=0)


@pytest.mark.parametrize("k1", [True, False], ids=["with_k1", "without_k1"])
def test_rk3_opens_a_gather_span_a_stage_inside_advect(k1):
    """_rk3 gathers the grids once a stage it computes (2 with k1 given, 3
    without), each inside a gather span, a child of advect; its one host
    wait (the cell scale's copy) lies outside every gather, and the
    positions are those of a call with recording off, bit for bit."""
    s = ft.step(ft.init_state(CFG, "cpu"), DT, CFG)
    given = s.k1 if k1 else None
    off = advect._rk3(CFG, s.u, s.v, s.w, given, s.pos, DT)
    with trace.recording() as rec:
        with trace.span("step"), trace.span("advect"):
            on = advect._rk3(CFG, s.u, s.v, s.w, given, s.pos, DT)
    gathers = [x for x in rec.spans if x.name == "gather"]
    syncs = [x for x in rec.spans if x.name == "sync"]
    assert len(gathers) == (2 if k1 else 3)
    assert all(g.parent == "advect" and g.step == 0 for g in gathers)
    assert not any(x.parent == "gather" for x in rec.spans)
    assert rec.counts == {0: {"sync": 1}} and len(syncs) == 1
    assert all(x.t1 <= g.t0 or g.t1 <= x.t0 for g in gathers for x in syncs)
    torch.testing.assert_close(on, off, rtol=0, atol=0)


def test_check_state_records_no_span_and_no_sync():
    """The demo's check runs between steps and feeds no metric: it adds
    nothing to a recording, so no step's counter carries its reads."""
    s = ft.step(ft.init_state(CFG, "cpu"), DT, CFG)  # the first state's phi is +inf
    with trace.recording() as rec:
        assert check_state(s)
    assert rec.spans == [] and rec.counts == {} and rec.steps == 0


# --- on the card -----------------------------------------------------------

DEMO = ft.SimConfig(nx=64, ny=64, nz=64, cells_per_meter=64.0, particles_per_cell_axis=2)
SMALL = ft.SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
SMALL2D = ft.SimConfig2D(nx=32, ny=32, cells_per_meter=32.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["flip", "apic"])
def test_host_syncs_are_the_sync_warnings_on_card(dev, family):
    """One step at the demo's size (after two to warm up): the step's
    ``sync`` count equals the warnings of set_sync_debug_mode("warn"). On
    the card the APIC P2G indexes its particles itself
    (ops/cuda_p2g_apic.py: build_csr_cells' bincount), 2 more than the
    CPU step's count. The mode watches the step alone: the recording's
    close, which reads the FLIP P2G kernel's device counters back (one
    synchronize, outside every step), lies outside it."""
    init, step, _, _, _, syncs = FAMILIES[family]
    syncs += 2 if family == "apic" else 0
    s = init(DEMO, dev)
    for _ in range(2):
        s = step(s, 1.0 / 120.0, DEMO)
    torch.cuda.synchronize()
    with trace.recording() as rec, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(s, 1.0 / 120.0, DEMO)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # (The mode's first use also warns that it is a prototype.)
    synced = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert rec.steps == 1
    assert len(synced) == rec.counts[0]["sync"] == syncs


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_state_is_the_same_with_tracing_on_and_off_on_card(dev, family):
    """A 32^3 (32^2) state stepped twice, then once with recording off and
    once on, events and all: FLIP's states bit-equal; the families whose
    P2G sums by index_add_'s atomics (APIC, the 2D steps; two runs differ
    with no recording) within the card-vs-CPU bound of test_torch_cuda.py,
    1e-4 abs and C within 2 m x 1e-4."""
    init, step, cfg, fields, _, _ = FAMILIES[family]
    cfg = SMALL if cfg is CFG else SMALL2D
    s = init(cfg, dev)
    for _ in range(2):
        s = step(s, 1.0 / 120.0, cfg)
    off = step(s, 1.0 / 120.0, cfg)
    with trace.recording(events=dev) as rec:
        on = step(s, 1.0 / 120.0, cfg)
    torch.cuda.synchronize()
    assert rec.steps == 1 and all(x.ms() >= 0.0 for x in rec.spans)
    for name in fields:
        atol = 0.0 if family == "flip" else 2 * cfg.nx * 1e-4 if name == "C" else 1e-4
        torch.testing.assert_close(getattr(on, name), getattr(off, name), rtol=0, atol=atol,
                                   msg=name)
