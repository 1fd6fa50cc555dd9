"""Where the step's time goes: per-stage times and the device's busy share.

The JAX package's utils/profiling.py runs each of the reference's profiler
marks (GPUProfiler.h:16-44) as its own blocked computation. Here the step
runs whole under utils/trace.py's recording with events: each span of the
step brackets its work with a pair of CUDA events on the current stream. A
stage's time is the device-timeline interval between its two events: its
kernels and the gaps where the card waited for the host to launch them. On
a CPU tensor the host clock takes the events' place (the CPU runs
synchronously). The device time of a step is what ``torch.profiler``
records on the card (kernels, copies and fills) over a few steps, per step.
The busy share is that time over the median step time without the
profiler; the profiler's own host cost stretches the profiled steps, so
their wall time is printed beside it but is not the share's denominator.

The demo's --profile table is the reference's: profile_step and
profile_step_apic run one step and sum the stages' times under the
reference's profiler marks (MARKS, MARK_OF_STAGE, keyed by span name),
which StageProfiler.table prints as the JAX package does.

The APIC step (solver/apic.py::step_apic) and the 2D steps
(solver/step2d.py::step2d, solver/apic2d.py::step_apic2d) emit the same
spans, the 2D ones without csr, sort, pass and blur: stage_times and
device_time step a state by its family's step.

Run on the card from the repository root:

    python -m fluidsimulation_tpu_torch.utils.profiling [--transfer apic] [--two-d] [--grid N]

It prints, for the three configurations chip_smoke.py drives (128^3 ppc 1,
the demo's 64^3 ppc 2, 128^3 ppc 2; with --transfer apic the APIC step at
the first two; with --two-d the 2D step at the 2D demo's 64^2 and at
512^2; with --grid N the one configuration N^3 ppc 1, or N^2), the
median time of each stage over steps 3-12 from the dam-break start, the
median step, and the device time of steps 13-15, the busy share,
the device events a step (each a launch: the step's launch count) and the
largest device events (kernels by name, the hand kernels among them) a
step.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import statistics
import time

import torch

from . import trace

TOP_EVENTS = 10  # device events listed by time under each configuration
# Spans that are not stages: the step's root, the parents whose children are
# timed in their place, and the spans inside a stage, whose time the stage's
# span already holds: the host waits, and the RK3 gathers inside advect
# (ops/advect.py), so that ADVECT counts their time once.
NOT_STAGES = {trace.STEP, "level_set", "project", trace.SYNC, "gather"}

# The reference's profiler marks, the GPUProfilerMark enum
# (GPUProfiler.h:16-44), in its order; copy of the JAX package's
# utils/profiling.py::MARKS.
MARKS = [
    "ADVECT",
    "TRANSFERPTG_CLEARCOUNTS",
    "TRANSFERPTG_COUNTPARTICLES",
    "TRANSFERPTG_PREFIXSUM_COPYMAP",
    "TRANSFERPTG_PREFIXSUM_WAIT",
    "TRANSFERPTG_PREFIXSUM_UNMAPUPDATE",
    "TRANSFERPTG_BIN",
    "TRANSFERPTG_LEVELSET_CLEAR",
    "TRANSFERPTG_LEVELSET_ZERO",
    "TRANSFERPTG_LEVELSET_SWEEP",
    "TRANSFERPTG_VELOCITY",
    "TRANSFERPTG_VELOCITY_EXTRAPOLATE",
    "FLIP_COPYVELOCITIES",
    "BODYFORCES",
    "PROJECT_RHS",
    "PROJECT_DIAGCOEFFS",
    "PROJECT_PCLEAR",
    "PROJECT_SOR",
    "PROJECT_TOVELOCITY",
    "FLIP_APPLY",
    "BLURLEVELSET",
    "DRAW",
    "END_FRAME",
]

# Short column headers, as in the reference's console table
# (FluidSimDemo.cpp:211).
SHORT = [
    "A", "TCC", "TCP", "TPC", "TPW", "TPU", "TB", "TLC", "TLZ", "TLS",
    "TV", "TE", "FC", "B", "PR", "PD", "PP", "PS", "PTV", "FCV", "BLS",
    "D", "EF",
]

# The mark each stage span is timed under. The CSR index and its sorted
# gather do the work of the reference's count, prefix-sum and bin trio, so
# the marks CLEARCOUNTS, COUNTPARTICLES and the three PREFIXSUM marks stay 0,
# as in the JAX package; so do LEVELSET_CLEAR, FLIP_COPYVELOCITIES and
# PROJECT_PCLEAR, which it never times either. particle_update is the FLIP
# update or the APIC G2P, p2g either family's P2G.
MARK_OF_STAGE = {
    "advect": "ADVECT",
    "csr": "TRANSFERPTG_BIN",
    "sort": "TRANSFERPTG_BIN",
    "seed": "TRANSFERPTG_LEVELSET_ZERO",
    "pass": "TRANSFERPTG_LEVELSET_ZERO",
    "sweeps": "TRANSFERPTG_LEVELSET_SWEEP",
    "p2g": "TRANSFERPTG_VELOCITY",
    "extrapolate": "TRANSFERPTG_VELOCITY_EXTRAPOLATE",
    "gravity": "BODYFORCES",
    "rhs": "PROJECT_RHS",
    "diag": "PROJECT_DIAGCOEFFS",
    "sor": "PROJECT_SOR",
    "apply": "PROJECT_TOVELOCITY",
    "particle_update": "FLIP_APPLY",
    "blur": "BLURLEVELSET",
}
STAGE_MARKS = list(dict.fromkeys(MARK_OF_STAGE.values()))  # the 13 marks a step times


def _stepper(state):
    """The step function of the state's family."""
    from ..core.state import ApicState, ApicState2D, SimState2D
    from ..solver.apic import step_apic
    from ..solver.apic2d import step_apic2d
    from ..solver.step2d import step2d
    from ..solver.step3d import step

    for cls, found in ((ApicState, step_apic), (SimState2D, step2d), (ApicState2D, step_apic2d)):
        if isinstance(state, cls):
            return found
    return step


@contextlib.contextmanager
def hooked(sites, around):
    """While open, a call to any ``(module, attr, label)`` of sites (module
    named under the package) runs ``around(label, orig, args)`` in place of
    ``orig(*args)``, where the caller's code looks the function up (keyword
    arguments of the call are bound into ``orig``). The originals come
    back on exit."""
    saved = []
    for mod_name, attr, label in sites:
        module = importlib.import_module(f"fluidsimulation_tpu_torch.{mod_name}")
        orig = getattr(module, attr)

        def hook(*args, _orig=orig, _label=label, **kwargs):
            return around(_label, functools.partial(_orig, **kwargs) if kwargs else _orig, args)

        saved.append((module, attr, orig))
        setattr(module, attr, hook)
    try:
        yield
    finally:
        for module, attr, orig in reversed(saved):
            setattr(module, attr, orig)


def stage_times(state, dt, cfg, n_steps: int):
    """Run n_steps steps of the state's family, each recorded with events
    and followed by a synchronize. Returns the final state, a list of
    {stage span: ms} per step, in the order the stages ran (a stage run
    several times in a step is summed), and the list of step times in ms
    (the ``step`` span's)."""
    step = _stepper(state)
    device = state.pos.device
    per_step, totals = [], []
    for _ in range(n_steps):
        with trace.recording(events=device) as rec:
            state = step(state, dt, cfg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        (spans,) = rec.step_spans()
        row: dict[str, float] = {}
        for s in spans:
            if s.name not in NOT_STAGES:
                row[s.name] = row.get(s.name, 0.0) + s.ms()
        per_step.append(row)
        totals.append(spans[0].ms())
    return state, per_step, totals


class StageProfiler:
    """One step's seconds under each of MARKS (the JAX package's
    StageProfiler; DT mirrors GPUProfiler::DT). A mark never timed reads
    0.0."""

    def __init__(self, device="cpu"):
        self.times: dict[str, float] = {m: 0.0 for m in MARKS}
        self.device = torch.device(device)

    def timed(self, mark: str, fn, *args, **kwargs):
        """fn(*args, **kwargs), its time stored under ``mark``: the
        CUDA-event interval of its work on the card (read after a
        synchronize), the host clock on the CPU."""
        start = trace.mark(self.device)
        out = fn(*args, **kwargs)
        end = trace.mark(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times[mark] = trace.elapsed_ms(start, end) / 1e3
        return out

    def DT(self, mark: str) -> float:
        return self.times.get(mark, 0.0)

    def table(self) -> str:
        """The reference's console table (FluidSimDemo.cpp:211-236), in the
        JAX package's format: a header of SHORT and a row of ms."""
        head = "GPU time:\t" + "\t".join(f"{s:<6}" for s in SHORT)
        vals = "GPU time:\t" + "\t".join(f"{1000.0 * self.times[m]:.2f}ms" for m in MARKS)
        return head + "\n" + vals


def _profile(step, state, dt, cfg, render_fn):
    """One ``step`` recorded with events; its stage spans' times summed
    under their marks (MARK_OF_STAGE), render_fn(new_state) under DRAW, and
    the closing wait for the card under END_FRAME."""
    device = state.pos.device
    prof = StageProfiler(device)
    with trace.recording(events=device) as rec:
        new_state = step(state, dt, cfg)
    if render_fn is not None:
        prof.timed("DRAW", render_fn, new_state)
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.times["END_FRAME"] = time.perf_counter() - t0
    for s in rec.spans:
        if s.name in MARK_OF_STAGE:
            prof.times[MARK_OF_STAGE[s.name]] += s.ms() / 1e3
    return new_state, prof


def profile_step(state, dt, cfg, render_fn=None):
    """Run ``step`` once with its stages timed under the reference's marks
    (the JAX package's profile_step). Returns (the state ``step`` returns,
    bit for bit, and a StageProfiler).

    The step is the port's own, run whole: each stage span is bracketed by
    CUDA events on the card (by the host clock on the CPU), and a mark's
    time is the sum of its stages' intervals (MARK_OF_STAGE).
    TRANSFERPTG_BIN is the CSR build and the sorted gather;
    TRANSFERPTG_LEVELSET_ZERO the own-cell seed and the 27-neighbourhood
    pass; TRANSFERPTG_VELOCITY_EXTRAPOLATE all three grids' extrapolation,
    where the JAX package times only u's. Because the stages are not
    separated by waits, a mark holds its kernels and the gaps in which the
    card waited for the host to launch them. ``render_fn(new_state)``, if
    given, is timed as DRAW (the reference's DrawScene,
    FluidSimDemo.cpp:175-208); END_FRAME is the host's closing wait for the
    card (the reference's blocking profiler collect, GPUProfiler.cpp:49-84),
    a call that returns at once on the CPU. The marks the JAX package never
    times read 0.0 (MARK_OF_STAGE)."""
    from ..solver.step3d import step

    return _profile(step, state, dt, cfg, render_fn)


def profile_step_apic(state, dt, cfg, render_fn=None):
    """profile_step for the APIC step (solver/apic.py::step_apic):
    TRANSFERPTG_VELOCITY is the APIC P2G, FLIP_APPLY the APIC G2P;
    FLIP_COPYVELOCITIES stays 0 (APIC keeps no old grids)."""
    from ..solver.apic import step_apic

    return _profile(step_apic, state, dt, cfg, render_fn)


def device_time(state, dt, cfg, n_steps: int):
    """Device time and wall time of n_steps steps (of the state's family)
    under torch.profiler. Returns (state, device ms a step, profiled wall
    ms a step, the device events as (name, ms a step), largest first, and
    the device events a step: kernels, copies and fills, each one launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = _stepper(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step(state, dt, cfg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Device-side events only: a CPU op's own device time repeats the time
    # of the kernels it launched, which appear again as device events.
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps) for e in device),
                    key=lambda kv: -kv[1])
    launches = sum(e.count for e in device) / n_steps
    return state, sum(ms for _, ms in events), wall_ms / n_steps, events, launches


def main(argv=None) -> int:
    import subprocess

    import fluidsimulation_tpu_torch as ft

    if not torch.cuda.is_available():
        raise SystemExit("profiling: torch.cuda.is_available() is false; this needs a CUDA card")
    ap = argparse.ArgumentParser(prog="python -m fluidsimulation_tpu_torch.utils.profiling")
    ap.add_argument("--transfer", choices=("flip", "apic"), default="flip",
                    help="the step to time: PIC/FLIP (step) or APIC (step_apic)")
    ap.add_argument("--two-d", action="store_true",
                    help="time the 2D step (step2d, or step_apic2d with --transfer apic)")
    ap.add_argument("--grid", type=int, default=0,
                    help="time one configuration: N^3 ppc 1 at dt 1/60 (with --two-d N^2 at "
                    "dt 1/120) in place of the default ones")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    configs = ((128, 1, 1.0 / 60.0), (64, 2, 1.0 / 120.0), (128, 2, 1.0 / 120.0))
    init = ft.init_state
    if args.two_d:
        # The 2D demo's grid and 512^2, at its dt = 1/60 x rate 0.5.
        configs = ((64, None, 1.0 / 120.0), (512, None, 1.0 / 120.0))
        init = ft.init_apic_state2d if args.transfer == "apic" else ft.init_state2d
    elif args.transfer == "apic":
        configs, init = configs[:2], ft.init_apic_state
    if args.grid:
        configs = ((args.grid, None if args.two_d else 1, configs[0][2]),)
    for n, ppc, dt in configs:
        if args.two_d:
            cfg, shape = ft.SimConfig2D(nx=n, ny=n, cells_per_meter=float(n)), f"{n}^2"
        else:
            cfg = ft.SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n),
                               particles_per_cell_axis=ppc)
            shape = f"{n}^3 ppc {ppc}"
        state = init(cfg, "cuda:0")
        state, _, _ = stage_times(state, dt, cfg, 2)  # warm-up: steps 1-2
        state, rows, totals = stage_times(state, dt, cfg, 10)
        state, device_ms, wall_ms, events, launches = device_time(state, dt, cfg, 3)
        print(f"\n{args.transfer} {shape}, {cfg.num_particles} particles, dt={dt!r}, "
              f"steps 3-12, medians of CUDA-event stage times, {card}")
        medians = {s: statistics.median(r[s] for r in rows) for s in rows[0]}
        for s in sorted(medians, key=medians.get, reverse=True):
            print(f"  {s:24s} {medians[s]:10.4f} ms")
        print(f"  {'sum of stages':24s} {sum(medians.values()):10.4f} ms")
        step_ms = statistics.median(totals)
        print(f"  {'step (median)':24s} {step_ms:10.4f} ms")
        print(f"  steps 13-15 under torch.profiler: device {device_ms:.4f} ms a step, "
              f"profiled wall {wall_ms:.4f} ms a step")
        print(f"  busy share: device ms a step / median step = {device_ms / step_ms:.4f}; "
              f"{launches:.0f} device events a step")
        for name, ms in events[:TOP_EVENTS]:
            print(f"    device {ms:9.4f} ms a step  {name[:100]}")
        print("", end="", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
