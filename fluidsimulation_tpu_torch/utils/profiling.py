"""The demo's --profile table: the step's stage times under the
reference's profiler marks, and ``hooked``, which wraps the functions a
step calls.

The JAX package's utils/profiling.py runs each of the reference's profiler
marks (GPUProfiler.h:16-44) as its own blocked computation. Here the step
runs whole under utils/trace.py's recording with events: each span of the
step brackets its work with a pair of CUDA events on the current stream. A
stage's time is the device-timeline interval between its two events: its
kernels and the gaps where the card waited for the host to launch them. On
a CPU tensor the host clock takes the events' place (the CPU runs
synchronously).

profile_step and profile_step_apic run one step and sum the stages' times
under the reference's profiler marks (MARKS, MARK_OF_STAGE, keyed by span
name), which StageProfiler.table prints as the JAX package does. A
kernel's device time comes from the benchmark's traced run
(``bench_torch/run.py --trace 1``).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import time

import torch

from . import trace

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
