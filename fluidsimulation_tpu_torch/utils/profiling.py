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

Run on the card from the repository root:

    python -m fluidsimulation_tpu_torch.utils.profiling

It prints, for the three configurations chip_smoke.py drives (128^3 ppc 1,
the demo's 64^3 ppc 2, 128^3 ppc 2), the median time of each stage over
steps 3-12 from the dam-break start, the median step, and the device time
of steps 13-15, the busy share and the largest device events (kernels by
name, the hand kernels among them) a step.
"""

from __future__ import annotations

import contextlib
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
STAGES = list(dict.fromkeys(label for _, _, label in SITES))


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
    ``orig(*args)``, where the step's code looks the function up. The
    originals come back on exit."""
    saved = []
    for mod_name, attr, label in sites:
        module = importlib.import_module(f"fluidsimulation_tpu_torch.{mod_name}")
        orig = getattr(module, attr)

        def hook(*args, _orig=orig, _label=label):
            return around(_label, _orig, args)

        saved.append((module, attr, orig))
        setattr(module, attr, hook)
    try:
        yield
    finally:
        for module, attr, orig in reversed(saved):
            setattr(module, attr, orig)


def stage_marks(device: torch.device, marks: list):
    """While open, every stage call appends (label, start, end) to marks."""

    def timed(label, orig, args):
        start = _Clock(device)
        out = orig(*args)
        marks.append((label, start, _Clock(device)))
        return out

    return hooked(SITES, timed)


def stage_times(state, dt, cfg, n_steps: int):
    """Run n_steps steps with every stage marked. Returns the final state,
    a list of {stage: ms} per step (a stage called several times in a step
    is summed) and the list of step times in ms."""
    from ..solver.step3d import step

    device = state.pos.device
    per_step, totals = [], []
    for _ in range(n_steps):
        marks: list = []
        with stage_marks(device, marks):
            begin = _Clock(device)
            state = step(state, dt, cfg)
            end = _Clock(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row = dict.fromkeys(STAGES, 0.0)
        for label, start, stop in marks:
            row[label] += start.ms_until(stop)
        per_step.append(row)
        totals.append(begin.ms_until(end))
    return state, per_step, totals


def device_time(state, dt, cfg, n_steps: int):
    """Device time and wall time of n_steps steps under torch.profiler.
    Returns (state, device ms a step, profiled wall ms a step, the device
    events as (name, ms a step), largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..solver.step3d import step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step(state, dt, cfg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Device-side events only: a CPU op's own device time repeats the time
    # of the kernels it launched, which appear again as device events.
    events = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                     for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda kv: -kv[1])
    return state, sum(ms for _, ms in events), wall_ms / n_steps, events


def main() -> int:
    import subprocess

    import fluidsimulation_tpu_torch as ft

    if not torch.cuda.is_available():
        raise SystemExit("profiling: torch.cuda.is_available() is false; this needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    for n, ppc, dt in ((128, 1, 1.0 / 60.0), (64, 2, 1.0 / 120.0), (128, 2, 1.0 / 120.0)):
        cfg = ft.SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n), particles_per_cell_axis=ppc)
        state = ft.init_state(cfg, "cuda:0")
        state, _, _ = stage_times(state, dt, cfg, 2)  # warm-up: steps 1-2
        state, rows, totals = stage_times(state, dt, cfg, 10)
        state, device_ms, wall_ms, events = device_time(state, dt, cfg, 3)
        print(f"\n{n}^3 ppc {ppc}, {cfg.num_particles} particles, dt={dt!r}, steps 3-12, "
              f"medians of CUDA-event stage times, {card}")
        medians = {s: statistics.median(r[s] for r in rows) for s in STAGES}
        for s in sorted(STAGES, key=medians.get, reverse=True):
            print(f"  {s:24s} {medians[s]:10.4f} ms")
        print(f"  {'sum of stages':24s} {sum(medians.values()):10.4f} ms")
        step_ms = statistics.median(totals)
        print(f"  {'step (median)':24s} {step_ms:10.4f} ms")
        print(f"  steps 13-15 under torch.profiler: device {device_ms:.4f} ms a step, "
              f"profiled wall {wall_ms:.4f} ms a step")
        print(f"  busy share: device ms a step / median step = {device_ms / step_ms:.4f}")
        for name, ms in events[:TOP_EVENTS]:
            print(f"    device {ms:9.4f} ms a step  {name[:100]}")
        print("", end="", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
