"""Where the step's time goes: per-stage times and the device's busy share.

The JAX package's utils/profiling.py runs each of the reference's profiler
marks (GPUProfiler.h:16-44) as its own blocked computation. Here each stage
function that ``step`` calls is wrapped where the step looks it up, and a
pair of CUDA events on the current stream brackets every call. A stage's
time is the device-timeline interval between its two events: its kernels
and the gaps where the card waited for the host to launch them. On a CPU
tensor the host clock takes the events' place (the CPU runs synchronously).
The device time of a step is what ``torch.profiler`` records on the card
(kernels, copies and fills) over a few steps, per step. The busy share is
that time over the median step time without the profiler; the profiler's
own host cost stretches the profiled steps, so their wall time is printed
beside it but is not the share's denominator.

The demo's --profile table is the reference's: profile_step and
profile_step_apic run one step through the same sites and sum the stage
times under the reference's profiler marks (MARKS, MARK_OF_STAGE), which
StageProfiler.table prints as the JAX package does.

The APIC step (solver/apic.py::step_apic) and the 2D steps
(solver/step2d.py::step2d, solver/apic2d.py::step_apic2d) are timed the
same way, through their own sites: stage_times and device_time step a
state by its family's step.

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

TOP_EVENTS = 10  # device events listed by time under each configuration

# (module, name the step's code looks up, stage label), in step order.
SITES = [
    ("solver.step3d", "advect_rk3_cached", "advect (RK3)"),
    ("solver.step3d", "advect_rk3", "advect (RK3)"),
    ("solver.step3d", "build_csr", "CSR build"),
    ("solver.step3d", "sort_particles", "sorted gather"),
    ("ops.levelset", "seed_own_cell", "own-cell seed"),
    ("ops.levelset", "neighborhood_pass", "27-neighbourhood pass"),
    ("ops.levelset", "sweep_closest", "24 sweeps"),
    ("solver.step3d", "p2g_from_csr", "P2G"),
    ("solver.step3d", "extrapolate_one_ring", "extrapolate"),
    ("solver.step3d", "add_gravity", "gravity"),
    ("ops.project", "compute_rhs", "RHS"),
    ("ops.project", "compute_diag", "diagonal"),
    ("ops.project", "sor_pressure", "SOR"),
    ("ops.project", "apply_pressure", "apply pressure"),
    ("solver.step3d", "flip_update_carry", "FLIP"),
    ("solver.step3d", "blur_phi", "blur"),
]
# The APIC step's sites: the level set and projection are the FLIP step's;
# advection, the transfers and the grid stages are looked up in solver/apic.py.
APIC_SITES = [
    ("solver.apic", "advect_rk3_pic", "advect (RK3)"),
    ("solver.apic", "build_csr", "CSR build"),
    ("solver.apic", "sort_particles", "sorted gather"),
    *(site for site in SITES if site[0] == "ops.levelset"),
    ("solver.apic", "p2g_apic", "APIC P2G"),
    ("solver.apic", "extrapolate_one_ring", "extrapolate"),
    ("solver.apic", "add_gravity", "gravity"),
    *(site for site in SITES if site[0] == "ops.project"),
    ("solver.apic", "g2p_apic", "APIC G2P"),
    ("solver.apic", "blur_phi", "blur"),
]

# The 2D steps' sites: the level set's seed and sweeps and the projection's
# parts are looked up in solver/step2d.py, the stages step_apic2d calls in
# solver/apic2d.py.
SITES_2D = [
    ("solver.step2d", "advect_rk3", "advect (RK3)"),
    ("solver.step2d", "seed_closest", "seed (own cell, 3x3)"),
    ("solver.step2d", "_sweep_axis2", "8 sweeps"),
    ("solver.step2d", "transfer_to_grid", "P2G"),
    ("solver.step2d", "extrapolate_full", "extrapolate"),
    ("solver.step2d", "add_gravity", "gravity"),
    ("solver.step2d", "compute_rhs2d", "RHS"),
    ("solver.step2d", "compute_diag2d", "diagonal"),
    ("solver.step2d", "sor_pressure", "SOR"),
    ("solver.step2d", "apply_pressure2d", "apply pressure"),
    ("solver.step2d", "flip_update2d", "FLIP"),
]
APIC2D_SITES = [
    ("solver.apic2d", "advect_rk3", "advect (RK3)"),
    *(site for site in SITES_2D if site[1] in ("seed_closest", "_sweep_axis2")),
    ("solver.apic2d", "p2g_apic2d", "APIC P2G"),
    ("solver.apic2d", "extrapolate_full", "extrapolate"),
    ("solver.apic2d", "add_gravity", "gravity"),
    *(site for site in SITES_2D if site[1] in ("compute_rhs2d", "compute_diag2d",
                                                "sor_pressure", "apply_pressure2d")),
    ("solver.apic2d", "g2p_apic2d", "APIC G2P"),
]


def stages_of(sites) -> list[str]:
    """The stage labels of ``sites``, in step order, each once."""
    return list(dict.fromkeys(label for _, _, label in sites))


STAGES = stages_of(SITES)
APIC_STAGES = stages_of(APIC_SITES)
STAGES_2D = stages_of(SITES_2D)
APIC2D_STAGES = stages_of(APIC2D_SITES)

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

# The mark each stage of SITES and APIC_SITES is timed under. The CSR index
# and its sorted gather do the work of the reference's count, prefix-sum and
# bin trio, so the marks CLEARCOUNTS, COUNTPARTICLES and the three PREFIXSUM
# marks stay 0, as in the JAX package; so do LEVELSET_CLEAR,
# FLIP_COPYVELOCITIES and PROJECT_PCLEAR, which it never times either.
MARK_OF_STAGE = {
    "advect (RK3)": "ADVECT",
    "CSR build": "TRANSFERPTG_BIN",
    "sorted gather": "TRANSFERPTG_BIN",
    "own-cell seed": "TRANSFERPTG_LEVELSET_ZERO",
    "27-neighbourhood pass": "TRANSFERPTG_LEVELSET_ZERO",
    "24 sweeps": "TRANSFERPTG_LEVELSET_SWEEP",
    "P2G": "TRANSFERPTG_VELOCITY",
    "APIC P2G": "TRANSFERPTG_VELOCITY",
    "extrapolate": "TRANSFERPTG_VELOCITY_EXTRAPOLATE",
    "gravity": "BODYFORCES",
    "RHS": "PROJECT_RHS",
    "diagonal": "PROJECT_DIAGCOEFFS",
    "SOR": "PROJECT_SOR",
    "apply pressure": "PROJECT_TOVELOCITY",
    "FLIP": "FLIP_APPLY",
    "APIC G2P": "FLIP_APPLY",
    "blur": "BLURLEVELSET",
}
STAGE_MARKS = list(dict.fromkeys(MARK_OF_STAGE.values()))  # the 13 marks a step times


def _stepper(state):
    """(step function, its sites) for the state's family."""
    from ..core.state import ApicState, ApicState2D, SimState2D
    from ..solver.apic import step_apic
    from ..solver.apic2d import step_apic2d
    from ..solver.step2d import step2d
    from ..solver.step3d import step

    for cls, found in ((ApicState, (step_apic, APIC_SITES)), (SimState2D, (step2d, SITES_2D)),
                       (ApicState2D, (step_apic2d, APIC2D_SITES))):
        if isinstance(state, cls):
            return found
    return step, SITES


class _Clock:
    """A mark on the device timeline (CUDA) or the host clock (CPU)."""

    def __init__(self, device: torch.device):
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        else:
            self.event, self.t = None, time.perf_counter()

    def ms_until(self, later: "_Clock") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return 1e3 * (later.t - self.t)


@contextlib.contextmanager
def hooked(sites, around):
    """While open, a call to any ``(module, attr, label)`` of sites (module
    named under the package) runs ``around(label, orig, args)`` in place of
    ``orig(*args)``, where the step's code looks the function up (keyword
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


def stage_marks(device: torch.device, marks: list, sites):
    """While open, every stage call of ``sites`` appends (label, start,
    end) to marks."""

    def timed(label, orig, args):
        start = _Clock(device)
        out = orig(*args)
        marks.append((label, start, _Clock(device)))
        return out

    return hooked(sites, timed)


def stage_times(state, dt, cfg, n_steps: int):
    """Run n_steps steps (step, or step_apic for an ApicState) with every
    stage marked. Returns the final state, a list of {stage: ms} per step
    (a stage called several times in a step is summed) and the list of
    step times in ms."""
    step, sites = _stepper(state)
    stages = stages_of(sites)
    device = state.pos.device
    per_step, totals = [], []
    for _ in range(n_steps):
        marks: list = []
        with stage_marks(device, marks, sites):
            begin = _Clock(device)
            state = step(state, dt, cfg)
            end = _Clock(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row = dict.fromkeys(stages, 0.0)
        for label, start, stop in marks:
            row[label] += start.ms_until(stop)
        per_step.append(row)
        totals.append(begin.ms_until(end))
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
        start = _Clock(self.device)
        out = fn(*args, **kwargs)
        end = _Clock(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times[mark] = start.ms_until(end) / 1e3
        return out

    def DT(self, mark: str) -> float:
        return self.times.get(mark, 0.0)

    def table(self) -> str:
        """The reference's console table (FluidSimDemo.cpp:211-236), in the
        JAX package's format: a header of SHORT and a row of ms."""
        head = "GPU time:\t" + "\t".join(f"{s:<6}" for s in SHORT)
        vals = "GPU time:\t" + "\t".join(f"{1000.0 * self.times[m]:.2f}ms" for m in MARKS)
        return head + "\n" + vals


def _profile(step, sites, state, dt, cfg, render_fn):
    """One ``step`` with its stages marked at ``sites``; the stages' times
    summed under their marks (MARK_OF_STAGE), render_fn(new_state) under
    DRAW, and the closing wait for the card under END_FRAME."""
    device = state.pos.device
    prof = StageProfiler(device)
    marks: list = []
    with stage_marks(device, marks, sites):
        new_state = step(state, dt, cfg)
    if render_fn is not None:
        prof.timed("DRAW", render_fn, new_state)
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.times["END_FRAME"] = time.perf_counter() - t0
    for label, start, stop in marks:
        prof.times[MARK_OF_STAGE[label]] += start.ms_until(stop) / 1e3
    return new_state, prof


def profile_step(state, dt, cfg, render_fn=None):
    """Run ``step`` once with its stages timed under the reference's marks
    (the JAX package's profile_step). Returns (the state ``step`` returns,
    bit for bit, and a StageProfiler).

    The step is the port's own, run whole: each stage call is bracketed by
    CUDA events on the card (by the host clock on the CPU) where the step
    looks it up (SITES), and a mark's time is the sum of its stages'
    intervals (MARK_OF_STAGE). TRANSFERPTG_BIN is the CSR build and the
    sorted gather; TRANSFERPTG_LEVELSET_ZERO the own-cell seed and the
    27-neighbourhood pass; TRANSFERPTG_VELOCITY_EXTRAPOLATE all three
    grids' extrapolation, where the JAX package times only u's. Because the
    stages are not separated by waits, a mark holds its kernels and the
    gaps in which the card waited for the host to launch them.
    ``render_fn(new_state)``, if given, is timed as DRAW (the reference's
    DrawScene, FluidSimDemo.cpp:175-208); END_FRAME is the host's closing
    wait for the card (the reference's blocking profiler collect,
    GPUProfiler.cpp:49-84), a call that returns at once on the CPU. The
    marks the JAX package never times read 0.0 (MARK_OF_STAGE)."""
    from ..solver.step3d import step

    return _profile(step, SITES, state, dt, cfg, render_fn)


def profile_step_apic(state, dt, cfg, render_fn=None):
    """profile_step for the APIC step (solver/apic.py::step_apic), through
    APIC_SITES: TRANSFERPTG_VELOCITY is the APIC P2G, FLIP_APPLY the APIC
    G2P; FLIP_COPYVELOCITIES stays 0 (APIC keeps no old grids)."""
    from ..solver.apic import step_apic

    return _profile(step_apic, APIC_SITES, state, dt, cfg, render_fn)


def device_time(state, dt, cfg, n_steps: int):
    """Device time and wall time of n_steps steps (of the state's family)
    under torch.profiler. Returns (state, device ms a step, profiled wall
    ms a step, the device events as (name, ms a step), largest first, and
    the device events a step: kernels, copies and fills, each one launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, _ = _stepper(state)
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
