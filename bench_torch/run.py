"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card. The cell names
a configuration (bench_torch/configs/<config>.json: the scene and the
program's entry points) and a traffic mix (bench_torch/traffic/<mix>.json:
the loop's parameters). ``--seed`` is the scene's LCG seed, the jitter of
the dam break, and the only thing that varies the data.

Set-up imports the program, builds its kernel library (into
build/fluidsimulation_tpu_torch/ inside the checkout, on a checkout's
first run only), makes the dam-break state from the seed on the card and
runs the mix's warm-up steps, so that every window starts at the same
simulated time. The window then runs the demo's 3D loop without frames for
``--seconds`` seconds: the step, a synchronize, and every 10th step the
demo's state check (an anomaly resets the state, as the demo does, and the
steps since the last check count as failed). After the window the plain
reference that the configuration's transfer names (references/<name>.py)
steps the state the program's last step started from, on the
configuration's scene, and the comparison (harness/compare.py) decides
``correct``.

With ``--trace 0`` the result carries the cell's end-to-end metrics:
setup_s, step_ms (the window's wall time over its steps, checks
included), step_ms_p95 (the 95th percentile of the step-to-synchronize
interval over every step of the window) and peak_mem_gib (the most the
window held allocated). With ``--trace 1`` the same window runs with spans
around the program's stage calls and a few short stretches profiled
(harness/tracing.py), and the result carries the cell's per-layer metrics,
each read by its file under bench_torch/metrics/, when the trace is whole,
and under "trace" the steps it kept and the stretches it dropped.

The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error. Without a card, or
with fewer cards than the cell asks for, it prints no result and exits 3;
if the process holds JAX or the JAX package once the window has closed, it
names them on standard error, prints no result and exits 4.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402

# One launching thread: no idle OpenMP workers beside it on the host.
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from harness import catalog, compare, device, stats, tracing  # noqa: E402

GIB = float(2**30)
DRIFT_BLOCKS = 10  # the window's step times are printed as this many block medians
# Top-level modules no run may hold: JAX and the JAX package the port was made from.
BARRED = frozenset({"jax", "jaxlib", "flax", "fluidsimulation_tpu"})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 bench_torch/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def resolve(spec: str):
    module, name = spec.split(":")
    return getattr(importlib.import_module(module), name)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def barred_modules() -> list[str]:
    """The top-level names of sys.modules that BARRED holds, each compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & BARRED)


class Program:
    """The system under test, as the configuration file names it."""

    def __init__(self, conf: dict, transfer: str, seed: int):
        prog = conf["program"]
        entries = prog["transfers"][transfer]
        ref = catalog.reference(entries["reference"])
        self.reference, self.fields = ref.step, ref.FIELDS
        self.package = prog["package"]
        self.cfg = resolve(prog["config"])(**conf["scene"], seed=seed)
        self.init = resolve(entries["init"])
        self.step = resolve(entries["step"])
        self.check = resolve(prog["check"])
        self.sites = catalog.sites(entries["sites"])


def caches_in_checkout() -> None:
    """Every kernel cache the program could fill lives inside the checkout,
    at a fixed path (its own library is built under build/ beside the
    package)."""
    base = catalog.ROOT / "build" / "bench_torch"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def main(argv=None, dev=None, conf=None) -> int:
    """One run. ``dev`` and ``conf`` are for the harness's own tests, which
    drive a run on the CPU at a small scene: ``dev`` skips the look for a
    card, and such a run reports no metric."""
    args = parse_args(argv)
    bench = catalog.benchmark()
    cell = catalog.workload(bench, args.workload)
    conf = conf or catalog.config(cell["config"])
    mix = catalog.traffic(cell["traffic"])
    if mix["render_every"]:
        raise SystemExit(f"traffic {cell['traffic']}: render_every must be 0 (frames are not measured)")
    e2e = catalog.end_to_end(bench, cell["name"])
    layers = catalog.per_layer(bench, cell["name"])
    readers = {m["name"]: catalog.metric_reader(m["name"]) for m in layers} if args.trace else {}

    import torch

    if dev is None:
        try:
            device.require(cell["chips"])
        except device.NoCard as exc:
            say(f"run.py: {exc}")
            return 3
        dev = torch.device("cuda:0")
    card = device.Card(dev)
    caches_in_checkout()
    if str(catalog.ROOT) not in sys.path:
        sys.path.insert(0, str(catalog.ROOT))
    prog = Program(conf, mix["transfer"], args.seed)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = float(min(max(mix["dt"] * mix["rate"], 0.0), conf["scene"]["max_dt"]))

    captured = tracing.Captures()
    spans = (tracing.spans(prog.package, prog.sites, captured) if args.trace
             else contextlib.nullcontext())
    with spans:
        loop = Loop(prog, dt, mix["check_every"], card)
        loop.warm_up(mix["warmup_steps"], args.trace)
        setup_peak = card.peak()
        setup_s = time.perf_counter() - T0
        card.reset_peak()
        # What set-up made stays: the collector's full passes skip it.
        gc.collect()
        gc.freeze()
        tracer = (tracing.Tracer(args.seconds, captured,
                                 [r.capture for r in readers.values() if hasattr(r, "capture")])
                  if args.trace else None)
        loop.window(args.seconds, tracer)
    window_peak = card.peak()

    # The check: the reference steps the state the last step started from.
    correct, checks = False, {}
    if loop.prev is not None:
        inp = {k: getattr(loop.prev, k) for k in prog.fields}
        out = {k: getattr(loop.state, k) for k in prog.fields}
        loop.prev = loop.state = None
        gc.collect()
        card.empty_cache()
        ref = prog.reference(conf["scene"], inp, dt)
        nums = compare.numbers(out, ref, prog.fields)
        del inp, out, ref
        checks = compare.checks(nums)
        correct = compare.passed(checks) and loop.failed == 0 and loop.setup_ok
        for name, f in nums["fields"].items():
            say(f"field {name}: off {f['off']}, rel_l2 {f['rel_l2']!r}, max_abs {f['max_abs']!r}")

    steps = loop.steps
    result = {"correct": correct, "attempted": steps, "failed": loop.failed, "metrics": {}}
    intervals = loop.intervals
    blocks = [statistics.median(intervals[i * steps // DRIFT_BLOCKS:(i + 1) * steps // DRIFT_BLOCKS])
              for i in range(DRIFT_BLOCKS) if (i + 1) * steps // DRIFT_BLOCKS > i * steps // DRIFT_BLOCKS]
    say(f"window: {steps} steps in {loop.wall_s!r} s; step medians by tenth of the window (ms): "
        + " ".join(f"{1e3 * b:.3f}" for b in blocks))
    if args.trace:
        trace = tracer.trace(conf["scene"], mix["transfer"])
        for m in layers if trace.whole else ():
            value = readers[m["name"]].read(trace)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if not trace.whole:
            say(f"trace: fewer than {tracing.STRETCHES} clean stretches; no per-layer metric")
        traced_at = set(loop.traced)
        traced = [loop.intervals[i] for i in loop.traced]
        untraced = [t for i, t in enumerate(loop.intervals) if i not in traced_at]
        if traced and untraced:
            say(f"tracing cost: traced steps' median {1e3 * statistics.median(traced)!r} ms, "
                f"the others' {1e3 * statistics.median(untraced)!r} ms")
        say(f"stretches, device operations a step: {tracer.summary()}")
        labels = sorted({o.label for s in trace.steps for o in s.ops if o.label})
        say("traced: %d steps kept, %d stretches dropped; device ms a step by span: %s" % (
            len(trace.steps), trace.dropped,
            ", ".join(f"{lab} {trace.stage_ms({lab})!r}" for lab in labels)))
    elif card.is_cuda:
        values = {
            "setup_s": setup_s,
            "step_ms": stats.step_ms(loop.wall_s, steps),
            "step_ms_p95": 1e3 * stats.p95(intervals),
            "peak_mem_gib": window_peak / GIB,
        }
        for m in e2e:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        if "step_ms_p95" in result["metrics"] and steps < stats.P95_MIN_SAMPLES:
            say(f"warning: {steps} steps in the window, fewer than {stats.P95_MIN_SAMPLES} for a p95")
    result["device"] = card.describe(cell["chips"], max(setup_peak, window_peak))
    if args.trace:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
        result["trace"] = {"kept_steps": len(trace.steps), "dropped_stretches": trace.dropped,
                           "whole": trace.whole}
    result["checks"] = checks
    for name, c in checks.items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    if not checks:
        say("check: no step to compare (the state was reset on the window's last step)")
    barred = barred_modules()
    if barred:
        say(f"run.py: the process holds {', '.join(barred)}; no result")
        return 4
    print(json.dumps(result), flush=True)
    return 0


class Loop:
    """The demo's 3D loop without frames: the step, a synchronize, and every
    ``check_every``-th step the state check, which resets the state on an
    anomaly. Holds the state, so that no other name keeps an old one alive."""

    def __init__(self, prog, dt, check_every, card):
        self.prog, self.dt, self.check_every, self.card = prog, dt, check_every, card
        self.state = prog.init(prog.cfg, card.dev)
        self.prev = None  # the state the last step started from
        self.steps = self.failed = 0
        self.setup_ok = True
        self.intervals: list[float] = []  # step call to the end of the synchronize, s
        self.traced: list[int] = []  # the steps run under the profiler
        self.wall_s = 0.0

    def warm_up(self, n: int, trace: bool) -> None:
        """n steps; with ``trace`` the last under the profiler, whose first
        start is slow."""
        for i in range(n):
            if trace and i == n - 1:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                    self.state = self.prog.step(self.state, self.dt, self.prog.cfg)
                    self.card.sync()
            else:
                self.state = self.prog.step(self.state, self.dt, self.prog.cfg)
        self.card.sync()
        if not self.prog.check(self.state):
            say("the state is not sound after the warm-up steps")
            self.setup_ok = False

    def iteration(self, span=None) -> None:
        if span is not None:
            self.traced.append(self.steps)
        with (span or contextlib.nullcontext)():
            t0 = time.perf_counter()
            new = self.prog.step(self.state, self.dt, self.prog.cfg)
            self.card.sync()
            t1 = time.perf_counter()
        self.prev, self.state = self.state, new
        del new
        self.intervals.append(t1 - t0)
        if self.steps % self.check_every == 0 and not self.prog.check(self.state):
            say(f"anomaly after step {self.steps} of the window; the state is reset")
            self.failed += min(self.check_every, self.steps + 1)
            self.prev, self.state = None, None
            self.state = self.prog.init(self.prog.cfg, self.card.dev)
        self.steps += 1

    def window(self, seconds: float, tracer) -> None:
        """Step for ``seconds`` seconds; with a tracer, profile its
        stretches when they are due."""
        start = time.perf_counter()
        while (elapsed := time.perf_counter() - start) < seconds:
            if tracer is not None and tracer.due(elapsed):
                tracer.stretch(self.iteration)
            else:
                self.iteration()
        self.wall_s = time.perf_counter() - start


if __name__ == "__main__":
    sys.exit(main())
