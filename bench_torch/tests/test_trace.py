"""The trace's reading from profiler events, on events made up here: the
attribution of device operations to steps and spans by their launches, the
union of device intervals, and the lost-record rule."""

import pytest
from torch.autograd import DeviceType

from harness import catalog, tracing


class Ev:
    def __init__(self, name, dev, start_us, dur_us, corr):
        self._n, self._d, self._s, self._u, self._c = name, dev, start_us, dur_us, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._u * 1000)

    def correlation_id(self):
        return self._c


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def one_iteration(t0, corr0):
    """An iteration of 100 us: the advect span launches two kernels, the sor
    span one (a hand kernel: no op around it), and a copy outside any span."""
    return [
        Ev("bench::iter", CPU, t0, 100, corr0),
        Ev("bench::advect", CPU, t0 + 1, 20, corr0 + 1),
        Ev("bench::advect", GPU, t0 + 5, 30, corr0 + 1),  # the span's device-side mirror
        Ev("cudaLaunchKernel", CPU, t0 + 2, 1, corr0 + 100),
        Ev("k_a", GPU, t0 + 5, 10, corr0 + 100),
        Ev("cudaLaunchKernel", CPU, t0 + 10, 1, corr0 + 101),
        Ev("k_b", GPU, t0 + 15, 20, corr0 + 101),
        Ev("bench::sor", CPU, t0 + 30, 10, corr0 + 2),
        Ev("cudaLaunchKernel", CPU, t0 + 31, 1, corr0 + 102),
        Ev("sor_kernel", GPU, t0 + 50, 30, corr0 + 102),
        Ev("cudaMemcpyAsync", CPU, t0 + 45, 1, corr0 + 103),
        Ev("Memcpy DtoD", GPU, t0 + 85, 5, corr0 + 103),
    ]


def trace_of(iterations):
    steps = [tracing.Step(a, b, ops, {"sor_fluid": 10, "sor_cells": 100})
             for a, b, ops in tracing.parse(iterations)]
    scene = {"nx": 4, "ny": 5, "nz": 5, "sor_iterations": 100}
    return tracing.Trace(steps, scene, "flip", dropped=0)


def test_parse_gives_each_operation_to_its_step_and_span():
    events = one_iteration(0, 0) + one_iteration(1000, 1000)
    trace = trace_of(events)
    assert len(trace.steps) == 2
    step = trace.steps[0]
    assert [(o.name, o.label) for o in sorted(step.ops, key=lambda o: o.start)] == [
        ("k_a", "advect"), ("k_b", "advect"), ("sor_kernel", "sor"), ("Memcpy DtoD", None)]
    # k_a [5, 15], k_b [15, 35], sor [50, 80], copy [85, 90]: 65 us busy of 100.
    assert trace.busy_s == pytest.approx(2 * 65e-6)
    assert trace.window_s == pytest.approx(2 * 100e-6)
    assert trace.stage_ms({"advect"}) == pytest.approx(0.030)
    assert trace.stage_ms({"sor"}) == pytest.approx(0.030)
    assert trace.stage_ms({"p2g"}) is None
    gaps = dict(trace.idle_gaps())
    assert gaps["advect"] == pytest.approx(2 * 5e-6)  # [0, 5] before k_a
    assert gaps["sor"] == pytest.approx(2 * 15e-6)  # [35, 50]
    assert gaps["step"] == pytest.approx(2 * 5e-6)  # [80, 85] before the copy
    assert gaps["sync"] == pytest.approx(2 * 10e-6)  # [90, 100]
    assert trace.device_ops()[0][0] in ("k_b", "sor_kernel")


def test_metric_readers_on_the_made_up_trace():
    trace = trace_of(one_iteration(0, 0))
    read = {n: catalog.metric_reader(n).read(trace) for n in (
        "device.idle", "step.launches", "step.device_ms", "stage.advect_ms",
        "stage.transfer_ms", "sor.roofline", "sweeps.roofline")}
    assert read["device.idle"] == pytest.approx(35.0)
    assert read["step.launches"] == 4
    assert read["step.device_ms"] == pytest.approx(0.065)
    assert read["stage.advect_ms"] == pytest.approx(0.030)
    assert read["stage.transfer_ms"] is None and read["sweeps.roofline"] is None
    # SOR: 16 B x 100 cells against 11 x 10 x 100 operations, over 30 us.
    least = max(1600 / 3.35e12, 11000 / 67e12)
    assert read["sor.roofline"] == pytest.approx(100 * least / 30e-6)


def test_a_stretch_that_lost_records_is_dropped():
    tracer = tracing.Tracer(10.0, tracing.Captures(), [])
    whole = [tracing.Step(0, 1, [tracing.Op("k", 0, 1, None)] * 4, {})] * tracing.STRETCH_STEPS
    lossy = [tracing.Step(0, 1, [tracing.Op("k", 0, 1, None)] * 3, {})] * tracing.STRETCH_STEPS
    tracer.stretches = [whole, lossy, whole]
    trace = tracer.trace({}, "flip")
    assert trace.dropped == 1 and len(trace.steps) == 2 * tracing.STRETCH_STEPS
    assert not trace.whole  # two kept of STRETCHES: no per-layer metric from it
    assert tracer.due(0.0)  # another is due
    tracer.stretches = [whole] * tracing.STRETCHES + [lossy]
    trace = tracer.trace({}, "flip")
    assert trace.whole and trace.dropped == 1
    assert len(trace.steps) == tracing.STRETCHES * tracing.STRETCH_STEPS
    assert not tracer.due(100.0)


def test_a_dropped_stretch_is_made_up_and_the_retries_end():
    tracer = tracing.Tracer(8.0, tracing.Captures(), [])
    whole = [tracing.Step(0, 1, [tracing.Op("k", 0, 1, None)] * 4, {})] * tracing.STRETCH_STEPS
    lossy = [tracing.Step(0, 1, [tracing.Op("k", 0, 1, tracing.LOST)] * 4, {})] * tracing.STRETCH_STEPS
    assert tracer.due(0.0)  # the first slot
    tracer.stretches = [whole]
    assert not tracer.due(0.5)  # the next slot is at 1 s
    tracer.stretches = [whole, whole]
    assert tracer.due(7.5)  # the slots left are gone: the rest are due at once
    assert tracer.due(7.6)
    tracer.stretches = [whole] * 3 + [lossy] * (tracing.STRETCHES + tracing.RETRIES - 3)
    assert not tracer.due(7.7)  # no more retries
    assert not tracer.trace({}, "flip").whole


def test_spans_hook_a_site_and_skip_a_missing_one(capsys):
    import fluidsimulation_tpu_torch.ops.blur as blur
    orig = blur.blur_phi
    captured = tracing.Captures()
    with tracing.spans("fluidsimulation_tpu_torch", [("ops.blur", "blur_phi", "blur"),
                                                     ("ops.blur", "no_such", "x")], captured):
        assert blur.blur_phi is not orig
        captured.active = True
        blur.blur_phi(__import__("torch").zeros(3, 3, 3))
    assert blur.blur_phi is orig
    assert list(captured) == ["blur"]
    assert "no_such not found" in capsys.readouterr().err


def test_a_stretch_drops_its_sessions_first_step(monkeypatch):
    """The profiler loses records at the start of a session: each stretch
    profiles one step more than it keeps, and keeps the last ones."""
    import types

    import torch.profiler

    class Session:
        profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: []))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Session())
    n = 1 + tracing.STRETCH_STEPS
    monkeypatch.setattr(tracing, "parse", lambda events: [
        (float(i), i + 0.5, [tracing.Op("k", float(i), i + 0.1, None)] * (3 if i else 1))
        for i in range(n)])
    ran = []
    tracer = tracing.Tracer(10.0, tracing.Captures(), [])
    tracer.stretch(lambda span: ran.append(span))
    assert len(ran) == n
    (kept,) = tracer.stretches
    assert [s.start for s in kept] == [float(i) for i in range(1, n)]
    assert all(len(s.ops) == 3 for s in kept)
