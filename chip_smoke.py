#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fluidsimulation_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/ (seven, and the slab
entries of two of them), compares each with its plain PyTorch version on
the card, and drives five 3D paths of the port, the 2D family's, the
demo's --profile and --serve, three 256^3 paths and the multi-rank family
(phase M), each with the launch counts set to 0 just before it and read
just after, and renders 800x600 frames of the level sets of the first
two:

  * the 128^3 dam break (1,000,188 particles, ppc 1, dt = 1/60) through
    ``step``, 20 steps;
  * the demo entry point at its defaults, ``app.demo.main``: 64^3, ppc 2,
    953,312 particles, 60 steps at rate 0.5, saving its final state;
  * the physical configuration of bench.py: 128^3, ppc 2, 8,001,504
    particles, dt = 1/120, 10 steps;
  * the APIC family (solver/apic.py::step_apic): the 128^3 dam break at
    ppc 1, 12 steps, and the demo at its defaults with --transfer apic;
  * the 2D family (solver/step2d.py::step2d, solver/apic2d.py::
    step_apic2d) through the demo's --two-d loop: the reference's 64^2
    (7,688 particles), 60 steps with frames, and 512^2 (520,200
    particles), 6 steps, each with --transfer flip and apic;
  * the demo's host side: --profile (the reference's 23-mark table, FLIP
    and APIC) and --serve (the live view, 3D and --two-d), with a client;
  * the 256^3 dam break: FLIP and APIC at ppc 1 (8,193,532 particles) and
    a 20-step guarded soak at ppc 2 (65,548,256 particles).

Every step of every path must launch each kernel the expected number of
times (the 24 sweeps are one C call, one launch count); the combined-key
pack, which no step calls, 0 times; an APIC step the FLIP P2G and the FLIP
gather 0 times too, and its own P2G kernel once (a FLIP step never). On the
final
states of the first two paths it then drives the combined-key interpolation
(core/interp_combined.py): the pack kernel, the interpolation of every
particle through its table, and RK3 stages 2-3 through it. A 32^3 card step
is compared with the same step on the CPU. Any failure raises, and then the
last line is not printed. Without a CUDA card it exits non-zero at once.

Phases, each printing before the next:
  0  card name and power limit; TF32 off
  1  kernel build (seconds)
  2  kernels vs plain versions at 32^3 (here), at 128^3 (after phase 3),
     at 64^3/ppc 2 (after phase 5), at 128^3/ppc 2 (after phase 6) and,
     for the pass, the sweeps and the SOR, at the APIC 128^3 step (phase
     A), on the inputs each kernel received in the last step of the path; P2G, the
     27-neighbourhood pass and the FLIP gather launched twice must give the
     same bits; at the last three, every kernel's device time under
     torch.profiler (the report's ms) and its time by events, the sweeps
     of each axis timed alone, the SOR's fluid cells per colour, grid
     barriers and the cost of one barrier
  3  20 steps at 128^3; launch counts per step; median step time
  4  the 32^3 card step of phase 2 vs the same step on the CPU; then the
     NaN rule: a 32^3 state with one NaN position, two guarded steps on the
     card, each launching every kernel once (no raise, unhealthy, only that
     particle non-finite, grids finite)
  5  the demo at its defaults; launches per step; checkpoint reload; one
     more step under set_sync_debug_mode("warn"): torch's synchronizing
     calls equal the step's sync counter (utils/trace.py)
  6  10 steps of 128^3 / ppc 2; median step time, peak device memory
  A  APIC: a 32^3 state stepped 3 times on the card vs the same steps on
     the CPU (1e-4 abs, C 2 m x 1e-4: apic_bound); 128^3 ppc 1 (1,000,188
     particles, dt = 1/60), 10 steps after 2 warm-up, median step and peak
     device memory, then the pass, the sweeps, the SOR and the APIC P2G vs
     their plain versions on the last step's inputs; 128^3 ppc 2
     (8,001,504 particles, dt = 1/120), 3 steps after 2 warm-up, median
     step and peak, then the APIC P2G kernel vs its plain form (validity
     equal but at the threshold, faces within the bound of reordering each
     face's sum, two launches bit-equal), timed (device time, by events,
     the plain form, the bound) and the whole p2g_apic call (index,
     gathers, kernel) by events; the demo at its defaults with --transfer apic (64^3, ppc 2,
     60 steps at rate 0.5, --save-state), median step, checkpoint reload
     bit for bit, the APIC P2G on its last step's inputs as at 128^3 ppc
     2, and its sync count as phase 5's; every step launching the pass,
     the sweeps, the APIC P2G and the SOR once and no other kernel; all
     fields finite
  7  combined-key interpolation, on the final state of phase 3 (128^3,
     after phase 3's kernel checks; its times reported) and of phase 5
     (64^3 ppc 2; times printed only): the pack's launch count, the pack vs
     its plain form bit for bit (int32 views) and a second launch bit-equal,
     the interpolation vs the pointwise one, RK3 vs advect_rk3_cached; the
     pack's device time under torch.profiler (the report's ms) and its time
     by events, beside a zero-fill of a table of the same bytes
  R  the renderer (render/raytrace.py, plain PyTorch, no hand kernel): a
     32^3 state stepped 3 times on the card, its 160x120 frame on the card
     vs the same phi's frame on the CPU (quirk pixels excluded); 800x600
     frames of the final phi of phase 3 (band_rows=100) and of phase 5
     (band_rows=64): finite, the shown frame's std > 0.01, 3 frames after
     1 warm-up timed by CUDA events, host syncs a frame, peak device
     memory a frame, sim_render_fps; at 128^3 also bounces 1 and 0 and
     overstep 1.5 once, and at both an untiled frame (band_rows=0) once,
     bit-equal to the tiled one; then the demo at 64^3 with --render-every
     writing PPM frames
  D  the 2D family: D1, a 32^2 state stepped 3 times on the card vs the
     same steps on the CPU, step2d and step_apic2d (1e-4 abs, C 2 m x
     1e-4), then the SOR kernel vs its plain version on the last step's
     (nx, ny, 1) inputs bit for bit, a second launch bit-equal and its
     counters, and the NaN rule (one NaN position, one step of each on the
     card: only that particle's rows non-finite, grids finite, the rest
     within the bound of the CPU step); D2, the demo entry point
     app.demo.main(["--two-d", ...]) at 64^2, 60 steps at rate 0.5 with
     --render-every 10, FLIP and APIC: median step by CUDA events, the SOR
     launched once a step and no other kernel, all fields finite, the
     frame2d_*.ppm frames written and decoded; D3, the same at --grid 512
     for 6 steps: median of 5 after 1 warm-up, peak device memory, the SOR
     vs its plain version on the last step's inputs (timed), all fields
     finite
  P  the app: P1, app.demo.main at its defaults with --profile, --steps 6
     --render-every 3 at 160x120, every profiled step through phase 5's
     launch check; its six printed tables each its profiler's table(),
     every stage mark > 0, the eight marks JAX never times 0, DRAW > 0 on
     steps 0 and 3 only, a step's stage marks and DRAW no more than its
     printed step time; then --transfer apic for 3 steps (phase A's
     launches); each mark's median. P2, --serve on a free port: the demo
     at 64^3 with a 160x120 frame a step and --steps 200, and a client
     thread that reads the page and one /stream part (a PNG decoding to a
     frame the demo wrote, or a 160x120 JPEG), posts 'o 10 -5' and '+',
     reads two more parts and posts 'q': the '+' doubles dt, the run ends
     before 200 steps and main returns 0; then the same with --two-d at
     64^2, Pillow hidden so that the view streams its zlib PNG
  B  256^3 (each sub-phase's wall seconds printed): B1, FLIP at ppc 1,
     8,193,532 particles, dt 1/60, 2 warm-up and 8 timed steps (median by
     CUDA events), peak device memory, all fields finite, the centre of
     mass fallen, then kernels 1-5 vs their plain versions on the last
     step's inputs, timed, with the sweeps by axis and the SOR's counters;
     B2, APIC at ppc 1, 1 warm-up and 4 timed steps, each launching the
     pass, the sweeps and the SOR and no other kernel, median step and
     peak; B3, the soak: ppc 2, 65,548,256 particles, dt 1/240, 20 steps
     of step_guarded, healthy on every one, |v|max and mean y every 5,
     median step and peak, then P2G's ppc >= 2 path vs its plain version
     on the last step's inputs (if the plain version does not fit, the
     bytes it asked for are printed; phase 6 holds it at 128^3 ppc 2)
  M  the multi-rank family (parallel/, render/sharded.py), after phase B:
     4 ranks over gloo sharing the card (NCCL refuses two ranks of one
     communicator on one card; gloo's send/recv take no CUDA tensor, so
     the point-to-point planes are staged through host buffers), spawned
     once after the build: M1, the FLIP halo step at 128^3 ppc 1
     (250,047 particles and 32 x-planes a rank), 3 steps; M2, the APIC
     halo step, 2 steps; M3, the demo's 64^3 ppc 2, 2 FLIP steps; each
     against the one-device steps on the card (FLIP: pos 1e-6, the rest
     1e-4, and it is bit for bit; APIC: apic_bound, beside two one-device
     runs' own difference), no particle dropped, every rank launching the
     pass, P2G and the FLIP gather once, fst_sweeps 8 times (y/z),
     fst_sweep_x_carry 8 (the relayed x-sweeps) and fst_sor_half 200 a
     step, fst_sor and the pack never; the two new entries against their
     plain versions on every rank's last inputs, and timed alone on rank
     1's; M4, the halo SOR at 128^3 against fst_sor; M5, an 800x600
     sharded frame of the 128^3 phi, bit for bit the tiled one; M6, a world
     of one NCCL rank, the FLIP halo step against the one-device step.
     Times are 4 ranks sharing one H100, not a speed across cards
  8  {"kernels": [...], "apic": {...}, "render": {...}, "two_d": {...},
     "app": {...}, "big": {...}, "multi": {...}} and then
     {"ok": true, "device": {...}}
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

DT = 1.0 / 60.0
N_STEPS = 20
N_WARMUP = 2
DEVICE = "cuda:0"
MAIN_N = 128  # grid cells per axis of the main path
MAIN_PARTICLES = 1_000_188
SMALL_N = 32
DEMO_STEPS = 60  # the demo's defaults: 64^3, ppc 2, rate 0.5
DEMO_PARTICLES = 953_312
PHYS_N = 128
PHYS_PARTICLES = 8_001_504
PHYS_DT = 1.0 / 120.0
PHYS_STEPS = 10
WIDTH, HEIGHT = 800, 600  # bench.py's frame
FRAMES = 3  # timed frames after one warm-up
SMALL_FRAME = (160, 120)
# Frames of two implementations (quirk pixels excluded): within FRAME_ATOL,
# but for at most FRAME_FRAC of the values, and those within FRAME_MAX (a
# march exit one step apart at a threshold).
FRAME_ATOL, FRAME_FRAC, FRAME_MAX = 2e-4, 1e-3, 0.5
FIELDS = ("pos", "vel", "u", "v", "w", "phi")
APIC_FIELDS = ("pos", "vel", "C", "u", "v", "w", "phi")
APIC_STEPS = 10  # timed APIC steps at 128^3, after N_WARMUP
APIC_PHYS_STEPS = 3  # timed APIC steps at 128^3 ppc 2, after N_WARMUP
APIC_ATOL = 1e-4  # phase A's card-vs-CPU bound (apic_bound)

TWO_D_DT = 1.0 / 120.0  # the 2D demo's dt: 1/60 at rate 0.5
TWO_D_SMALL = 32
TWO_D_DEMO_PARTICLES = 7_688  # the demo's 64^2 (BASELINE.json config 1)
TWO_D_DEMO_STEPS = 60
TWO_D_RENDER_EVERY = 10
TWO_D_BIG = 512
TWO_D_BIG_PARTICLES = 520_200
TWO_D_BIG_STEPS = 6  # 1 warm-up and 5 timed
TWO_D_WARMUP = 1
BAD = 5  # the particle that gets a NaN position (phases 4 and D1)

# Phase P: the demo's --profile and --serve.
PROFILE_STEPS, PROFILE_APIC_STEPS, PROFILE_EVERY = 6, 3, 3
SERVE_STEPS = 200  # the most a --serve run may take; its client quits it long before
SERVE_TIMEOUT = 120.0  # seconds the client waits for the demo's view, and to join
# Marks a --profile step never times (utils/profiling.py::MARK_OF_STAGE).
JAX_ZERO_MARKS = ("TRANSFERPTG_CLEARCOUNTS", "TRANSFERPTG_COUNTPARTICLES",
                  "TRANSFERPTG_PREFIXSUM_COPYMAP", "TRANSFERPTG_PREFIXSUM_WAIT",
                  "TRANSFERPTG_PREFIXSUM_UNMAPUPDATE", "TRANSFERPTG_LEVELSET_CLEAR",
                  "FLIP_COPYVELOCITIES", "PROJECT_PCLEAR")

# Phase B: 256^3, the JAX package's recorded capability point.
BIG_N = 256
BIG_PARTICLES = {1: 8_193_532, 2: 65_548_256}
BIG_FLIP_STEPS = 8  # timed, after N_WARMUP
BIG_APIC_STEPS, BIG_APIC_WARMUP = 4, 1
SOAK_DT = 1.0 / 240.0
SOAK_STEPS = 20
SOAK_EVERY = 5  # steps between the soak's |v|max and mean-y lines

MULTI_RANKS = 4  # phase M: gloo ranks sharing the one card
MULTI_DEMO_N = 64  # the demo's grid (ppc 2, DEMO_PARTICLES)
MULTI_FLIP_STEPS, MULTI_APIC_STEPS, MULTI_DEMO_STEPS = 3, 2, 2
# The multi-rank FLIP step against the one-device step on the card: the
# JAX package's bounds (tests/test_parallel.py:69-74; it is bit for bit).
# The APIC step's P2G sums by index_add_, whose atomics add in no fixed order
# on the card, so two one-device APIC runs differ too (printed beside):
# phase A's card bound (apic_bound).
MULTI_FLIP_BOUNDS = ({"pos": 1e-6}, 1e-4)

# H100 SXM data-sheet peaks at 700 W: device memory rate, and float32
# outside the tensor cores (every kernel here is float32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events, after one
    warm-up run."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds a run of fn() keeps the card busy: the device
    events (kernels, copies, fills) it launches, summed under
    torch.profiler, after one warm-up run. Unlike cuda_ms it leaves out the
    gaps where the card waits for the host to launch the next call, which
    set cuda_ms of a kernel shorter than about 0.03 ms. A profile that
    lost records is taken again, up to three times, then cuda_ms stands
    in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        # Every run launches its kernel at least once: a profile holding
        # fewer records of its most frequent event lost some, and its sum
        # would read low.
        records = max((e.count for e in device), default=0)
        if records >= reps:
            return sum(e.self_device_time_total for e in device) / 1e3 / reps
        say(f"device_ms: the profiler recorded {records} device events of {reps} runs; again")
    ms = cuda_ms(fn, reps)
    say(f"device_ms: records lost three times; {ms!r} ms by CUDA events instead")
    return ms


def capture(store: dict):
    """While open, record the arguments the step passes to each kernel
    wrapper, under the wrapper's key."""
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    def record(key, orig, args):
        store[key] = args
        return orig(*args)

    return hooked([
        ("ops.levelset", "neighborhood_pass", "seed"),
        ("ops.levelset", "sweep_closest", "sweep"),
        ("ops.p2g", "p2g_accumulate", "p2g"),
        ("ops.project", "sor_pressure", "sor"),
        ("solver.step2d", "sor_pressure", "sor"),
        ("ops.flip", "g2p_flip", "g2p"),
        ("ops.cuda_p2g_apic", "p2g_apic_sorted", "p2g_apic"),
        ("solver.apic", "p2g_apic", "p2g_apic_call"),
    ], record)


def kernel_table():
    """One entry per line of the kernels report. ``site`` names the capture
    key whose arguments the entry's wrapper takes."""
    from fluidsimulation_tpu_torch.ops import (
        cuda_g2p,
        cuda_p2g,
        cuda_p2g_apic,
        cuda_seed,
        cuda_sor,
        cuda_sweep,
    )
    from fluidsimulation_tpu_torch.ops.apic import p2g_apic_cells
    from fluidsimulation_tpu_torch.ops.common import cell_scale

    def p2g_plain(cfg, pcs, vels, start):
        return cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels)

    def p2g_apic_plain(cfg, pcs, vels, cs, start, thresh):
        return p2g_apic_cells(cfg, pcs, vels, cs.reshape(-1, 3, 3), cell_scale(cfg, pcs.device))

    return {
        "seed": dict(
            module=cuda_seed, wrapper=cuda_seed.neighborhood_pass,
            plain=cuda_seed.neighborhood_pass_plain, site="seed",
            name="neighborhood_pass", source="fluidsimulation_tpu_torch/csrc/seed.cu",
            replaces="fluidsimulation_tpu/ops/pallas_seed.py:22",
        ),
        "sweep": dict(
            module=cuda_sweep, wrapper=cuda_sweep.sweep_closest,
            plain=cuda_sweep.sweep_closest_plain, site="sweep",
            name="sweep_closest", source="fluidsimulation_tpu_torch/csrc/sweep.cu",
            replaces="fluidsimulation_tpu/ops/pallas_sweep.py:30",
        ),
        "p2g": dict(
            module=cuda_p2g, wrapper=cuda_p2g.p2g_accumulate, plain=p2g_plain, site="p2g",
            name="p2g_accumulate", source="fluidsimulation_tpu_torch/csrc/p2g.cu",
            replaces="fluidsimulation_tpu/ops/pallas_p2g_super.py:71",
        ),
        "p2g2": dict(
            module=cuda_p2g, wrapper=cuda_p2g.p2g_accumulate, plain=p2g_plain, site="p2g",
            name="p2g_accumulate_ppc2", source="fluidsimulation_tpu_torch/csrc/p2g.cu",
            replaces="fluidsimulation_tpu/ops/pallas_p2g.py:54",
        ),
        "g2p": dict(
            module=cuda_g2p, wrapper=cuda_g2p.g2p_flip, plain=cuda_g2p.g2p_flip_plain,
            site="g2p", name="g2p_flip", source="fluidsimulation_tpu_torch/csrc/g2p.cu",
            replaces="fluidsimulation_tpu/core/pallas_pairpack.py:52",
        ),
        "sor": dict(
            module=cuda_sor, wrapper=cuda_sor.sor_pressure, plain=cuda_sor.sor_pressure_plain,
            site="sor", name="sor_pressure", source="fluidsimulation_tpu_torch/csrc/sor.cu",
            replaces="fluidsimulation_tpu/ops/pallas_sor.py:68",
        ),
        # The launch alone, on the CSR-sorted inputs its caller made.
        "p2g_apic": dict(
            module=cuda_p2g_apic, wrapper=cuda_p2g_apic.p2g_apic_sorted, plain=p2g_apic_plain,
            site="p2g_apic", name="p2g_apic", source="fluidsimulation_tpu_torch/csrc/p2g_apic.cu",
            replaces="none: fluidsimulation_tpu/ops/apic.py::p2g_apic is XLA's scatter",
        ),
    }


def per_step_launches() -> dict:
    """Kernel module -> launches in one step, on every path."""
    from fluidsimulation_tpu_torch.core import cuda_pack
    from fluidsimulation_tpu_torch.ops import (
        cuda_g2p,
        cuda_p2g,
        cuda_p2g_apic,
        cuda_seed,
        cuda_sor,
        cuda_sweep,
    )

    return {cuda_seed: 1, cuda_sweep: 1, cuda_p2g: 1, cuda_sor: 1, cuda_g2p: 1, cuda_pack: 0,
            cuda_p2g_apic: 0}


class LaunchCheck:
    """Counts set to 0 when a path starts; each step must launch each
    kernel its expected number of times (``expect``, by default a step's);
    ``totals`` read when it ends."""

    def __init__(self, label: str, expect: dict | None = None):
        self.label = label
        self.expect = per_step_launches() if expect is None else expect
        for module in self.expect:
            module.KERNEL.launches = 0
        self.steps = 0

    def step(self, fn):
        before = {m: m.KERNEL.launches for m in self.expect}
        out = fn()
        for m, n in self.expect.items():
            got = m.KERNEL.launches - before[m]
            if got != n:
                raise AssertionError(f"{self.label} step {self.steps}: {m.KERNEL.symbol} "
                                     f"launched {got} times, expected {n}")
        self.steps += 1
        return out

    def totals(self) -> dict:
        out = {m.KERNEL.symbol: m.KERNEL.launches for m in self.expect}
        for m, per_step in self.expect.items():
            if per_step and out[m.KERNEL.symbol] == 0:
                raise AssertionError(f"{self.label}: {m.KERNEL.symbol} was never launched")
        say(f"{self.label}: launches in {self.steps} steps: "
            + ", ".join(f"{k}={v}" for k, v in out.items()))
        return out


def bound(key: str, args) -> tuple[float, str]:
    """Least time the card could take for the function, in ms: the larger of
    the bytes it must move (inputs read once, outputs written once) over
    the memory rate and its float32 operations over the peak rate.
    Operation counts per unit of work, each sum, product, compare, floor,
    sqrt or division counted as one:
      distance |a - b| - r and its compare: 11 (seed x27 a cell, sweep x24);
      P2G: per particle and component, 3 axis splits (9), 8 hat weights
        (16), 8 accumulations of w*vel and w (24): 147 a particle;
      G2P: 6 trilinear gathers of 7 lerps (126), 6 axis splits with clamps
        (33), the FLIP blend (6) and the diff g - beta*g_old at each of the
        24 corner values (48): 213 a particle; its bytes: the particle's
        position and velocity read and vel' and k1 written, and the new and
        old grids read once (the CSR order it is walked by counts against
        the kernel, not the bound);
      SOR: 6 neighbour subtractions, b - nms, two products, a division and
        a sum, 11 per fluid cell per iteration (this run's fluid cells);
      the combined pack: copies, no operations; it reads the three grids
        and writes the (nx*ny*(nz-1), 64) table;
      APIC P2G: per particle and component, each axis's shift, t - 0.5 and
        floor (9) and at its 3 nodes d, the spline's 6 operations and 2
        compares, and the lever's negation and division (99), and at each of
        the 27 nodes the weight's 2 products, the affine value's 3 products
        and 3 sums, w * value and the 2 accumulations (297): 1,215 a
        particle, and the division, clamp and compare at each face; its
        bytes: the particle's position, velocity and C (60 B) read, the CSR
        offsets read, and the three grids and their validity (5 B a face)
        written.
    """
    cfg = args[0]
    # The grid from the arguments' level set, so that the 2D solve's
    # (nx, ny, 1) counts too.
    cells = args[1].numel() if key == "sor" else cfg.nx * cfg.ny * cfg.nz
    if key in ("p2g", "p2g2", "g2p", "pack", "p2g_apic"):
        faces = sum(math.prod(s) for s in (cfg.u_shape(), cfg.v_shape(), cfg.w_shape()))
    if key == "seed":
        nbytes, ops = (12 + 4 + 12) * cells, 27 * 11 * cells
    elif key == "sweep":
        nbytes, ops = 2 * (4 + 12) * cells, 24 * 11 * cells
    elif key in ("p2g", "p2g2"):
        n = args[1].shape[0]
        nbytes, ops = 24 * n + 4 * (cells + 1) + 2 * 4 * faces, 147 * n
    elif key == "g2p":
        n = args[1].shape[0]
        nbytes, ops = 48 * n + 2 * 4 * faces, 213 * n
    elif key == "p2g_apic":
        n = args[1].shape[0]
        nbytes, ops = 60 * n + 4 * (cells + 1) + 5 * faces, 1215 * n + 3 * faces
    elif key == "sor":
        fluid = int((args[1] < 0).sum())
        nbytes, ops = 4 * 4 * cells, 11 * fluid * cfg.sor_iterations
    elif key == "pack":
        nbytes, ops = 4 * faces + 4 * 64 * cfg.nx * cfg.ny * (cfg.nz - 1), 0
    elif key == "sweep_x":
        # One x-sweep of a slab: phi and cpos read and written, the carry
        # plane read and the last plane written.
        phi = args[1]
        cells, plane = phi.numel(), phi[0].numel()
        nbytes, ops = 2 * (4 + 12) * cells + 2 * 12 * plane, 11 * cells
    elif key == "sor_half":
        # One half-update of a slab: p, phi, diag and b read, p written, the
        # four halo planes read; 11 operations a fluid cell of the colour.
        cfg, p, phi = args[0], args[1], args[4]
        cells, plane = p.numel(), p[0].numel()
        x0, color = args[9], args[10]
        sx, ny, nz = p.shape
        parity = ((x0 + torch.arange(sx, device=p.device))[:, None, None]
                  + torch.arange(ny, device=p.device)[None, :, None]
                  + torch.arange(nz, device=p.device)[None, None, :]) % 2
        fluid = int(((phi < 0) & (parity == color)).sum())
        nbytes, ops = 5 * 4 * cells + 4 * 4 * plane, 11 * fluid
    else:
        raise KeyError(key)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def apic_sums(cfg, pcs, vels, cs) -> list:
    """For each component of the APIC P2G of pcs (cell units), vels and cs
    ((N, 9) affine rows), formed as ops/apic.py::p2g_apic_cells forms it:
    each face's weight sum, its sum of w |value| and its count of terms."""
    from fluidsimulation_tpu_torch.ops.apic import _component_nodes, _shapes
    from fluidsimulation_tpu_torch.ops.common import cell_scale

    m = cell_scale(cfg, pcs.device)
    out = []
    for comp_axis, shape in _shapes(cfg):
        _, sy, sz = shape
        amt, sabs, terms = (torch.zeros(math.prod(shape), dtype=torch.float32, device=pcs.device)
                            for _ in range(3))
        crow = cs[:, 3 * comp_axis:3 * comp_axis + 3]
        for idx, ok, w, dxm in _component_nodes(cfg, pcs, comp_axis, m):
            lin = torch.where(ok, (idx[0] * sy + idx[1]) * sz + idx[2], 0)
            val = vels[:, comp_axis] + crow[:, 0] * dxm[0] + crow[:, 1] * dxm[1] + crow[:, 2] * dxm[2]
            amt.index_add_(0, lin, torch.where(ok, w, 0.0))
            sabs.index_add_(0, lin, torch.where(ok, w * val.abs(), 0.0))
            terms.index_add_(0, lin, ok.float())
        out.append(tuple(t.reshape(shape) for t in (amt, sabs, terms)))
    return out


def compare(key: str, got, want, args=None) -> tuple[float, str]:
    """Hold a kernel's outputs against its plain version's (``args``: the
    inputs both took). Returns the largest absolute difference and a note;
    raises past the tolerance."""
    if key in ("sor", "sweep"):
        # -fmad=false, IEEE sqrt and division, the plain version's operation
        # order: bit for bit.
        pairs = [(got, want)] if key == "sor" else list(zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in pairs)
        if not all(torch.equal(g, w) for g, w in pairs):
            raise AssertionError(f"{key}: not bit-exact (max abs err {err})")
        return err, "bit-exact"
    if key in ("seed", "g2p"):
        # -fmad=false, IEEE sqrt, the plain version's operation order; the
        # pass skips only candidates whose squared distance cannot win:
        # bit for bit.
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{key}: not bit-exact (max abs err {err})")
        return err, "bit-exact"
    if key in ("p2g", "p2g2"):
        # Summation order differs (gather vs index_add_): validity equal
        # except within rounding of the threshold; rtol = atol = 2e-4 on
        # faces valid in both.
        err, flips = 0.0, 0
        for (acc_k, amt_k), (acc_p, amt_p) in zip(got, want):
            vk, vp = amt_k > 0.01, amt_p > 0.01
            near = (amt_p - 0.01).abs() < 1e-6
            bad = (vk != vp) & ~near
            if bool(bad.any()):
                raise AssertionError(f"{key}: {int(bad.sum())} faces differ in validity")
            flips += int((vk != vp).sum())
            both = vk & vp
            gk = acc_k / amt_k.clamp(min=1e-30)
            gp = acc_p / amt_p.clamp(min=1e-30)
            d = (gk - gp).abs()[both]
            if d.numel() and bool((d > 2e-4 + 2e-4 * gp.abs()[both]).any()):
                raise AssertionError(f"{key}: normalised faces differ by up to {float(d.max())}")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        return err, f"validity equal ({flips} faces within 1e-6 of the threshold flip)"
    if key == "p2g_apic":
        # Summation order differs (the kernel's CSR order and pieces vs the
        # plain form's index_add_ atomics): validity equal except within
        # 1e-6 of the threshold; the same faces non-finite; on faces valid
        # in both, the difference within what reordering a sum of n terms
        # can move it, 4 n u (sum of w |value|) / (sum of w), u = 2^-24
        # (each sum moves by at most (n - 1) u times the sum of its terms'
        # sizes). A dropped or doubled term of a face moves it by about its
        # term's share, past that bound for all but the densest faces.
        # Beside it, the largest difference as a share of |b| + the grid's
        # rms (tests/test_torch_apic_kernel.py bounds that by 1e-5 where no
        # cell is dense).
        from fluidsimulation_tpu_torch.ops.apic import APIC_WEIGHT_THRESH

        err, flips, worst, tightest = 0.0, 0, 0.0, 0.0
        for g, b, vg, vb, (amt, sabs, terms) in zip(got[:3], want[:3], got[3:], want[3:],
                                                   apic_sums(*args[:4])):
            near = (amt - APIC_WEIGHT_THRESH).abs() < 1e-6
            bad = (vg != vb) & ~near
            if bool(bad.any()):
                raise AssertionError(f"{key}: {int(bad.sum())} faces differ in validity")
            if not torch.equal(g.isfinite(), b.isfinite()):
                raise AssertionError(f"{key}: the non-finite faces differ")
            flips += int((vg != vb).sum())
            both = vg & vb & b.isfinite()
            d, ref = (g - b).abs()[both], b.abs()[both]
            if d.numel():
                limit = 4 * terms[both] * 2.0**-24 * sabs[both] / amt[both]
                # 0 where equal (the limit is 0 where every term is).
                tightest = max(tightest, float(torch.where(d == 0, 0.0, d / limit).max()))
                worst = max(worst, float((d / (ref + ref.square().mean().sqrt())).max()))
                err = max(err, float(d.max()))
        if tightest > 1:
            raise AssertionError(f"{key}: faces differ by up to {tightest} of the reordering bound")
        return err, (f"validity equal ({flips} faces within 1e-6 of the threshold flip), "
                     f"largest difference {tightest!r} of the reordering bound, {worst!r} of "
                     f"|b| + rms")
    raise KeyError(key)


def tensors(out) -> list:
    """A wrapper's outputs as a flat list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in tensors(part)]


def check_kernels(table, keys, captured, label: str, results: dict, timed=(),
                  reported=()) -> None:
    """Compare each kernel in ``keys`` with its plain version on the
    captured inputs and print its bound there; time the kernels in
    ``timed``. The times and bounds of those in ``reported`` go to the
    report. Every error goes to the report's maximum."""
    for key in keys:
        k = table[key]
        args = captured[k["site"]]
        got = k["wrapper"](*args)
        want = k["plain"](*args)
        torch.cuda.synchronize()
        err, note = compare(key, got, want, args)
        if key in ("p2g", "p2g2", "seed", "g2p", "p2g_apic"):
            # No atomics, a fixed order: a second launch gives the same bits.
            again = k["wrapper"](*args)
            if not all(torch.equal(a, b) for a, b in zip(tensors(got), tensors(again))):
                raise AssertionError(f"{key} [{label}]: two launches on the same inputs differ")
            note += "; two launches bit-equal"
        entry = results.setdefault(key, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        b_ms, b_by = bound(key, args)
        line = (f"phase 2 [{label}] {k['name']}: max_abs_err={err!r} ({note}), "
                f"bound {b_ms!r} ms ({b_by})")
        if key in timed:
            reps_plain = 2 if key == "sweep" else 10
            ms = device_ms(lambda: k["wrapper"](*args), 20)
            wall_ms = cuda_ms(lambda: k["wrapper"](*args), 20)
            plain_ms = cuda_ms(lambda: k["plain"](*args), reps_plain)
            if key in reported:
                entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            line += (f"; kernel {ms!r} ms of device time ({wall_ms!r} ms by events, back to "
                     f"back), plain {plain_ms!r} ms")
        say(line)


def sweep_sor_details(captured, label: str, card: str) -> None:
    """Phase 2, beside the sweeps' and the SOR's checks on a path's inputs:
    the sweeps of each axis timed alone (its 8 codes in SWEEP_ORDER's
    order, one C call); the SOR kernel's counters (fluid cells of each
    colour, grid barriers run), held against the level set; and the cost of
    one grid barrier: the solve on an all-air level set (no cell to update,
    so the list build and the barriers) less the same with 0 iterations,
    over the barriers."""
    from fluidsimulation_tpu_torch.ops import cuda_sor, cuda_sweep

    cfg, phi, cpos = captured["sweep"]
    by_axis = []
    for axis, name in enumerate("xyz"):
        codes = [c for c in cuda_sweep.SWEEP_ORDER if cuda_sweep.CODE[c][0] == axis]
        ms = cuda_ms(lambda c=codes: cuda_sweep.sweeps(cfg, phi, cpos, c), 20)
        by_axis.append(f"{len(codes)} {name}-sweeps {ms!r} ms")
    say(f"phase 2 [{label}] sweeps by axis: " + ", ".join(by_axis) + f" on {card}")

    cfg, phi, diag, b = captured["sor"]
    _, counters = cuda_sor.sor_launch(cfg, phi, diag, b)
    n0, n1, barriers = counters.tolist()
    fluid = int((phi < 0).sum())
    if n0 + n1 != fluid or barriers != 2 * cfg.sor_iterations - 1:
        raise AssertionError(f"sor [{label}]: counters {counters.tolist()}, expected {fluid} fluid "
                             f"cells and {2 * cfg.sor_iterations - 1} barriers")
    air = torch.ones_like(phi)
    none = dataclasses.replace(cfg, sor_iterations=0)
    air_ms = cuda_ms(lambda: cuda_sor.sor_launch(cfg, air, diag, b), 20)
    prologue_ms = cuda_ms(lambda: cuda_sor.sor_launch(none, air, diag, b), 20)
    say(f"phase 2 [{label}] sor: fluid cells {n0} of colour 0, {n1} of colour 1; {barriers} grid "
        f"barriers; all-air solve {air_ms!r} ms, its prologue {prologue_ms!r} ms, so "
        f"{1e3 * (air_ms - prologue_ms) / barriers!r} us a barrier on {card}")


def timed_steps(check, n_steps, state, dt, cfg, captured, step=None, warmup=N_WARMUP):
    """n_steps of ``step`` (by default the PIC/FLIP step) through the
    launch check, CUDA-event timed; the last step's kernel arguments go to
    ``captured``. Returns the state and the step times after the
    ``warmup`` steps."""
    import fluidsimulation_tpu_torch as ft

    step = ft.step if step is None else step
    times = []
    for i in range(n_steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == n_steps - 1:
            with capture(captured):
                state = check.step(lambda: step(state, dt, cfg))
        else:
            state = check.step(lambda: step(state, dt, cfg))
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return state, times


def check_finite(label: str, state) -> None:
    for name in (*FIELDS, "k1", "C"):
        t = getattr(state, name, None)
        if t is not None and not bool(t.isfinite().all()):
            raise AssertionError(f"{label}: non-finite values in {name}")


def advect_through_table(cfg, tab, state, dt):
    """advect_rk3_cached with RK3 stages 2-3 interpolating through the
    combined table; stage 1 is the state's carried k1."""
    from fluidsimulation_tpu_torch.core.interp_combined import interp_mac3_combined_vec
    from fluidsimulation_tpu_torch.ops.advect import advect_rk3_cached
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    stages = []

    def through_table(label, orig, args):
        stages.append(label)
        return interp_mac3_combined_vec(tab, (cfg.nx, cfg.ny, cfg.nz), args[3])

    with hooked([("ops.advect", "interp_mac3_vec", "interp")], through_table):
        out = advect_rk3_cached(cfg, state.u, state.v, state.w, state.k1, state.pos, dt)
    if len(stages) != 2:
        raise AssertionError(f"RK3 through the table: {len(stages)} stages interpolated, expected 2")
    return out


def run_combined(label, cfg, state, dt, results, card, report) -> int:
    """Phase 7: the combined-key interpolation on a path's final state.

    With every count at 0: pack the grids (one kernel launch), interpolate
    every particle through the table and run RK3 stages 2-3 through it.
    Then hold the table against the plain form bit for bit (int32 views,
    so NaN payloads and -0.0 count) and against a second launch, the
    interpolation against the pointwise interp_mac3_vec within 2e-6 x
    max(1, largest |face value|) (the JAX test's 2e-6, scaled to the
    state's velocities), and the positions against advect_rk3_cached within
    1e-6 m x the same scale: a one-ulp difference in stage 2 moves the
    stage-3 query by an ulp, and a steep field turns that into a velocity
    difference past the interpolation's own (PERF.md, section 6). Then time
    the pack (device time under torch.profiler, and by events), its plain
    form, the torch.stack yardstick, a zero-fill of a table of the same
    bytes and both interpolations; the pack's times go to the report if
    ``report``.
    Returns the pack's launches in the drive."""
    from fluidsimulation_tpu_torch.core import cuda_pack
    from fluidsimulation_tpu_torch.core.interp import interp_mac3_vec
    from fluidsimulation_tpu_torch.core.interp_combined import (
        interp_mac3_combined_vec,
        pack_mac3_combined,
    )
    from fluidsimulation_tpu_torch.ops.advect import advect_rk3_cached
    from fluidsimulation_tpu_torch.ops.common import cell_scale

    if state.k1 is None:
        raise AssertionError(f"phase 7 [{label}]: the state carries no k1")
    u, v, w, dims = state.u, state.v, state.w, (cfg.nx, cfg.ny, cfg.nz)
    pc = state.pos * cell_scale(cfg, state.pos.device)
    check = LaunchCheck(f"phase 7 ({label})",
                        {m: int(m is cuda_pack) for m in per_step_launches()})

    def drive():
        tab = pack_mac3_combined(u, v, w)
        return tab, interp_mac3_combined_vec(tab, dims, pc), advect_through_table(cfg, tab, state, dt)

    tab, vel, newpos = check.step(drive)
    torch.cuda.synchronize()
    launches = check.totals()[cuda_pack.KERNEL.symbol]

    plain = cuda_pack.pack_mac3_combined_plain(u, v, w)
    pack_err = float((tab - plain).abs().max())
    exact = torch.equal(tab.view(torch.int32), plain.view(torch.int32))
    del plain
    again = torch.equal(tab.view(torch.int32), pack_mac3_combined(u, v, w).view(torch.int32))
    scale = max(1.0, *(float(g.abs().max()) for g in (u, v, w)))
    interp_err = float((vel - interp_mac3_vec(u, v, w, pc)).abs().max())
    pos_diff = (newpos - advect_rk3_cached(cfg, u, v, w, state.k1, state.pos, dt)).abs()
    pos_err = float(pos_diff.max())
    b_ms, b_by = bound("pack", (cfg,))
    say(f"phase 7 [{label}]: pack {tuple(tab.shape)} ({tab.numel() * 4} B) max abs err "
        f"{pack_err!r} (bits equal: {exact}; a second launch's bits equal: {again}), bound "
        f"{b_ms!r} ms ({b_by}); {pc.shape[0]} particles, largest |face| "
        f"{scale!r}: combined vs pointwise interpolation max abs diff {interp_err!r} (limit "
        f"{2e-6 * scale!r}); RK3 stages 2-3 through the table vs advect_rk3_cached "
        f"{pos_err!r} m (limit {1e-6 * scale!r}; {int((pos_diff > 1e-6).sum())} coordinates "
        f"past 1e-6 m)")
    if not exact:
        raise AssertionError(f"phase 7 [{label}]: pack not bit-exact (max abs err {pack_err})")
    if not again:
        raise AssertionError(f"phase 7 [{label}]: two pack launches on the same grids differ")
    if interp_err > 2e-6 * scale:
        raise AssertionError(f"phase 7 [{label}]: combined vs pointwise interpolation differ by "
                             f"{interp_err} > 2e-6 x {scale}")
    if pos_err > 1e-6 * scale:
        raise AssertionError(f"phase 7 [{label}]: RK3 through the table differs by {pos_err} m "
                             f"> 1e-6 x {scale}")
    entry = results.setdefault("pack", {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], pack_err)
    views = cuda_pack.shifted_views(u, v, w)
    ms = device_ms(lambda: pack_mac3_combined(u, v, w), 20)
    wall_ms = cuda_ms(lambda: pack_mac3_combined(u, v, w), 20)
    plain_ms = cuda_ms(lambda: cuda_pack.pack_mac3_combined_plain(u, v, w), 10)
    # The yardstick: one torch.stack of the 51 shifted views (of grids padded
    # before timing) along a new last axis makes the table's 51 data lanes;
    # the 13 zero lanes are left out. The port never calls it.
    library_ms = cuda_ms(lambda: torch.stack(views, dim=-1), 10)
    # What the card's own fill reaches on the table's bytes: a store-rate
    # ceiling for the pack (printed, not a bound).
    scratch = torch.empty_like(tab)
    fill_ms = device_ms(scratch.zero_, 20)
    del scratch
    combined_ms = cuda_ms(lambda: interp_mac3_combined_vec(tab, dims, pc), 10)
    pointwise_ms = cuda_ms(lambda: interp_mac3_vec(u, v, w, pc), 10)
    if report:
        entry.update(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=library_ms)
    say(f"phase 7 [{label}]: pack kernel {ms!r} ms of device time ({wall_ms!r} ms by events, "
        f"back to back), plain {plain_ms!r} ms, torch.stack of the 51 views {library_ms!r} ms, "
        f"zero-fill of a table {fill_ms!r} ms of device time, bound {b_ms!r} ms; "
        f"interpolation of {pc.shape[0]} "
        f"particles: combined (table given) {combined_ms!r} ms, pointwise {pointwise_ms!r} ms "
        f"on {card}")
    return launches


def nan_phase(cfg, dev) -> None:
    """Phase 4, the NaN rule on the card: one particle of the 32^3 dam break
    gets a NaN position and step_guarded runs twice. Nothing may raise (a
    device-side assert would end the run here), the state must be reported
    unhealthy, exactly that particle non-finite, and u, v, w, phi finite."""
    import fluidsimulation_tpu_torch as ft

    bad = BAD
    state = ft.init_state(cfg, dev)
    state.pos[bad, 0] = float("nan")
    check = LaunchCheck("phase 4 (NaN rule)")
    for i in range(2):
        state, healthy = check.step(lambda: ft.step_guarded(state, DT, cfg))
        torch.cuda.synchronize()
        if bool(healthy):
            raise AssertionError(f"phase 4 NaN step {i}: healthy is True")
        for name in ("pos", "vel"):
            rows = (~getattr(state, name).isfinite().all(1)).nonzero().flatten().tolist()
            if rows != [bad]:
                raise AssertionError(f"phase 4 NaN step {i}: non-finite {name} rows {rows[:10]}, "
                                     f"expected [{bad}]")
        for name in ("u", "v", "w", "phi"):
            if not bool(getattr(state, name).isfinite().all()):
                raise AssertionError(f"phase 4 NaN step {i}: non-finite values in {name}")
    check.totals()
    say(f"phase 4: NaN rule: particle {bad} of {state.pos.shape[0]} with a NaN position, two "
        f"guarded steps on the card: no raise, healthy False, only it non-finite, u v w phi finite")


def drive_demo(label, check, transfer, load, fields, card):
    """app.demo.main at its defaults with ``--transfer transfer`` and
    --save-state, every step through the launch check and CUDA-event
    timed, the last step's kernel arguments captured; check_state's
    verdicts all true, every field finite, the centre of mass fallen, the
    checkpoint reloaded by ``load`` equal to the final state in ``fields``.
    Returns (median step ms, the final state, its cfg, its dt, captured)."""
    from fluidsimulation_tpu_torch.app import demo
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    step_attr = "step_apic" if transfer == "apic" else "step"
    times, seen, verdicts, captured = [], {}, [], {}

    def counted_step(orig_step, state, dt, cfg):
        i = check.steps
        if i == 0:
            if state.pos.shape[0] != DEMO_PARTICLES:
                raise AssertionError(f"{label}: expected {DEMO_PARTICLES} particles, "
                                     f"got {state.pos.shape[0]}")
            seen["y0"] = float(state.pos[:, 1].mean())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == DEMO_STEPS - 1:
            with capture(captured):
                out = check.step(lambda: orig_step(state, dt, cfg))
        else:
            out = check.step(lambda: orig_step(state, dt, cfg))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        seen["state"], seen["cfg"], seen["dt"] = out, cfg, dt
        return out

    def recorded_check(orig_check, state):
        ok = orig_check(state)
        verdicts.append(ok)
        return ok

    def around(name, orig, args):
        return (counted_step if name == "step" else recorded_check)(orig, *args)

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        with hooked([("app.demo", step_attr, "step"), ("app.demo", "check_state", "check")],
                    around):
            rc = demo.main(["--device", "cuda", "--transfer", transfer, "--save-state",
                            "--out", out_dir])
        if rc != 0:
            raise AssertionError(f"{label}: main returned {rc}")
        if check.steps != DEMO_STEPS:
            raise AssertionError(f"{label}: ran {check.steps} steps, expected {DEMO_STEPS}")
        if not verdicts or not all(verdicts):
            raise AssertionError(f"{label}: check_state verdicts {verdicts}")
        state, cfg = seen["state"], seen["cfg"]
        check_finite(label, state)
        y1 = float(state.pos[:, 1].mean())
        if not y1 < seen["y0"]:
            raise AssertionError(f"{label}: centre of mass did not fall ({seen['y0']} -> {y1})")
        loaded = load(str(Path(out_dir) / "final_state.npz"), state.pos.device, cfg)
        for name in fields:
            if not torch.equal(getattr(loaded, name), getattr(state, name)):
                raise AssertionError(f"{label}: checkpoint field {name} differs from the final "
                                     "state")
    step_ms = statistics.median(times[N_WARMUP:])
    say(f"{label}: {check.steps} steps of {cfg.nx}^3, {DEMO_PARTICLES} particles; all fields "
        f"finite; mean y {seen['y0']!r} -> {y1!r}; checkpoint reloads equal; "
        f"{len(verdicts)} check_state verdicts all true")
    say(f"{label}: median step {step_ms!r} ms over {len(times) - N_WARMUP} steps after "
        f"{N_WARMUP} warm-up (min {min(times[N_WARMUP:])!r}, max {max(times[N_WARMUP:])!r}) "
        f"on {card}")
    return step_ms, state, cfg, seen["dt"], captured


def run_demo(table, results, card):
    """Phase 5: app.demo.main at its defaults, every step through the
    launch check; then the kernels on the last step's inputs and phase 7
    on the final state."""
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.utils.checkpoint import load_state

    check = LaunchCheck("phase 5 (demo 64^3 ppc 2)")
    step_ms, state, cfg, dt, captured = drive_demo("phase 5", check, "flip", load_state, FIELDS,
                                                   card)
    launches = check.totals()
    check_host_syncs("phase 5 host syncs", ft.step, state, dt, cfg)
    check_kernels(table, ("seed", "sweep", "p2g2", "sor", "g2p"), captured,
                  f"{cfg.nx}^3 ppc 2", results, timed=("seed", "sweep", "p2g2", "sor", "g2p"),
                  reported=("p2g2",))
    sweep_sor_details(captured, f"{cfg.nx}^3 ppc 2", card)
    combined_launches = run_combined(f"{cfg.nx}^3 ppc 2", cfg, state, dt, results,
                                     card, report=False)
    return launches, step_ms, combined_launches, state.phi


def run_physical(table, results, card):
    """Phase 6: the physical configuration, 10 steps; then the kernels on
    the last step's inputs, each timed (printed, not reported: the report's
    times are those at 128^3 ppc 1 and, for P2G at ppc 2, the demo's)."""
    import fluidsimulation_tpu_torch as ft

    cfg = ft.SimConfig(nx=PHYS_N, ny=PHYS_N, nz=PHYS_N, cells_per_meter=float(PHYS_N),
                       particles_per_cell_axis=2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ft.init_state(cfg, DEVICE)
    n = state.pos.shape[0]
    say(f"phase 6: {PHYS_N}^3 ppc 2, {n} particles, dt={PHYS_DT!r}, {PHYS_STEPS} steps")
    if n != PHYS_PARTICLES:
        raise AssertionError(f"expected {PHYS_PARTICLES} particles, got {n}")
    check = LaunchCheck("phase 6 (128^3 ppc 2)")
    captured: dict = {}
    state, times = timed_steps(check, PHYS_STEPS, state, PHYS_DT, cfg, captured)
    launches = check.totals()
    check_finite("phase 6", state)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    say(f"phase 6: all fields finite; median step {step_ms!r} ms over {len(times)} steps after "
        f"{N_WARMUP} warm-up (min {min(times)!r}, max {max(times)!r}); peak device memory "
        f"{peak} B ({peak / 2**30:.3f} GiB) on {card}")
    check_kernels(table, ("seed", "sweep", "p2g2", "sor", "g2p"), captured,
                  f"{PHYS_N}^3 ppc 2", results, timed=("seed", "sweep", "p2g2", "sor", "g2p"))
    sweep_sor_details(captured, f"{PHYS_N}^3 ppc 2", card)
    return launches, step_ms, peak


def apic_launches() -> dict:
    """Kernel module -> launches in one APIC step: the 27-neighbourhood
    pass, the sweeps, the APIC P2G and the SOR once; the FLIP P2G, the FLIP
    gather and the pack never (G2P is plain PyTorch)."""
    from fluidsimulation_tpu_torch.ops import cuda_p2g_apic, cuda_seed, cuda_sor, cuda_sweep

    return {m: int(m in (cuda_seed, cuda_sweep, cuda_p2g_apic, cuda_sor))
            for m in per_step_launches()}


def apic_bound(name: str, cfg) -> float:
    """Phase A's card-vs-CPU bound: phase 4's 1e-4 abs, and for C that
    bound carried through G2P's lever, C = 4 m^2 sum w v (x_i - x_p) with
    sum w |x_i - x_p| about half a cell: 2 m x 1e-4 (m = nx: the grids
    here are cubes and squares)."""
    return 2 * cfg.nx * APIC_ATOL if name == "C" else APIC_ATOL


def p2g_apic_call_ms(captured, label: str, card: str) -> float:
    """The whole APIC P2G on the card (the index of the particles, their
    gather into its order and the kernel: solver/apic.py's ``p2g`` span)
    by CUDA events, on the arguments the step gave it."""
    from fluidsimulation_tpu_torch.ops.apic import p2g_apic

    ms = cuda_ms(lambda: p2g_apic(*captured["p2g_apic_call"]), 20)
    say(f"phase 2 [{label}] p2g_apic: the whole call (CSR index, gathers, kernel) {ms!r} ms by "
        f"events on {card}")
    return ms


def run_apic(table, results, card) -> dict:
    """Phase A: the APIC family (solver/apic.py::step_apic) on the card.
    A 32^3 state stepped 3 times on the card and on the CPU; 128^3 ppc 1,
    N_WARMUP + APIC_STEPS steps, and the demo with --transfer apic, every
    step through the launch check; the kernels on the last 128^3 step's
    inputs."""
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.utils.checkpoint import load_apic_state

    out: dict = {}
    small = ft.SimConfig(nx=SMALL_N, ny=SMALL_N, nz=SMALL_N, cells_per_meter=float(SMALL_N),
                         particles_per_cell_axis=1)
    cpu_state = ft.init_apic_state(small, "cpu")
    card_state = cpu_state.to(DEVICE)
    check = LaunchCheck(f"phase A ({SMALL_N}^3)", apic_launches())
    for _ in range(3):
        cpu_state = ft.step_apic(cpu_state, DT, small)
        card_state = check.step(lambda: ft.step_apic(card_state, DT, small))
    torch.cuda.synchronize()
    check.totals()
    errs = {}
    for name in APIC_FIELDS:
        d = float((getattr(card_state, name).cpu() - getattr(cpu_state, name)).abs().max())
        errs[name] = d
        limit = apic_bound(name, small)
        say(f"phase A: {SMALL_N}^3, 3 steps, card vs CPU, {name}: max abs diff {d!r} "
            f"(limit {limit!r})")
        if not d <= limit:
            raise AssertionError(f"phase A: {name} differs by {d} > {limit}")
    out[f"card_vs_cpu_{SMALL_N}^3"] = errs

    cfg = ft.SimConfig(nx=MAIN_N, ny=MAIN_N, nz=MAIN_N, cells_per_meter=float(MAIN_N),
                       particles_per_cell_axis=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ft.init_apic_state(cfg, DEVICE)
    if state.pos.shape[0] != MAIN_PARTICLES:
        raise AssertionError(f"phase A: expected {MAIN_PARTICLES} particles, "
                             f"got {state.pos.shape[0]}")
    y0 = float(state.pos[:, 1].mean())
    check = LaunchCheck(f"phase A (APIC {MAIN_N}^3 ppc 1)", apic_launches())
    captured: dict = {}
    state, times = timed_steps(check, N_WARMUP + APIC_STEPS, state, DT, cfg, captured,
                               step=ft.step_apic)
    launches = check.totals()
    check_finite("phase A", state)
    y1 = float(state.pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"phase A: centre of mass did not fall ({y0} -> {y1})")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    say(f"phase A: APIC {MAIN_N}^3 ppc 1, {MAIN_PARTICLES} particles, dt={DT!r}: all fields "
        f"finite, mean y {y0!r} -> {y1!r}; median step {step_ms!r} ms over {len(times)} steps "
        f"after {N_WARMUP} warm-up (min {min(times)!r}, max {max(times)!r}); peak device memory "
        f"{peak} B ({peak / 2**30:.3f} GiB) on {card}")
    check_kernels(table, ("seed", "sweep", "sor", "p2g_apic"), captured, f"APIC {MAIN_N}^3",
                  results, timed=("seed", "sweep", "sor"))
    del state, captured
    label = f"{MAIN_N}^3 ppc 1"
    out.update(step_ms={label: step_ms}, step_times={label: times}, peak_bytes={label: peak},
               launches={label: launches})

    # The physical 128^3 configuration with APIC: the P2G kernel timed on
    # its last step's inputs.
    cfg = ft.SimConfig(nx=PHYS_N, ny=PHYS_N, nz=PHYS_N, cells_per_meter=float(PHYS_N),
                       particles_per_cell_axis=2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = ft.init_apic_state(cfg, DEVICE)
    if state.pos.shape[0] != PHYS_PARTICLES:
        raise AssertionError(f"phase A: expected {PHYS_PARTICLES} particles, "
                             f"got {state.pos.shape[0]}")
    check = LaunchCheck(f"phase A (APIC {PHYS_N}^3 ppc 2)", apic_launches())
    captured = {}
    state, times = timed_steps(check, N_WARMUP + APIC_PHYS_STEPS, state, PHYS_DT, cfg, captured,
                               step=ft.step_apic)
    label = f"{PHYS_N}^3 ppc 2"
    out["launches"][label] = check.totals()
    check_finite("phase A", state)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    say(f"phase A: APIC {label}, {PHYS_PARTICLES} particles, dt={PHYS_DT!r}: all fields finite; "
        f"median step {step_ms!r} ms over {len(times)} steps after {N_WARMUP} warm-up (min "
        f"{min(times)!r}, max {max(times)!r}); peak device memory {peak} B "
        f"({peak / 2**30:.3f} GiB) on {card}")
    check_kernels(table, ("p2g_apic",), captured, f"APIC {label}", results, timed=("p2g_apic",),
                  reported=("p2g_apic",))
    out["p2g_apic_call_ms"] = {label: p2g_apic_call_ms(captured, label, card)}
    out["step_ms"][label], out["step_times"][label], out["peak_bytes"][label] = step_ms, times, peak
    del state, captured

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    check = LaunchCheck("phase A (APIC demo 64^3 ppc 2)", apic_launches())
    demo_ms, state, demo_cfg, demo_dt, captured = drive_demo("phase A demo", check, "apic",
                                                              load_apic_state, APIC_FIELDS, card)
    demo_launches = check.totals()
    check_kernels(table, ("p2g_apic",), captured, "APIC demo 64^3 ppc 2", results,
                  timed=("p2g_apic",))
    out["p2g_apic_call_ms"]["demo 64^3 ppc 2"] = p2g_apic_call_ms(captured, "APIC demo 64^3 ppc 2",
                                                                  card)
    del captured
    check_host_syncs("phase A demo host syncs", ft.step_apic, state, demo_dt, demo_cfg)
    demo_peak = torch.cuda.max_memory_allocated()
    say(f"phase A demo: peak device memory {demo_peak} B ({demo_peak / 2**30:.3f} GiB)")
    label = "demo 64^3 ppc 2"
    out["step_ms"][label], out["peak_bytes"][label] = demo_ms, demo_peak
    out["launches"][label] = demo_launches
    return out


def two_d_launches() -> dict:
    """Kernel module -> launches in one 2D step: the SOR once and no other
    kernel (the 2D stages besides the solve are plain PyTorch)."""
    from fluidsimulation_tpu_torch.ops import cuda_sor

    return {m: int(m is cuda_sor) for m in per_step_launches()}


def two_d_family(apic: bool):
    """(init, step, its name in app.demo, fields, label) of a 2D family."""
    import fluidsimulation_tpu_torch as ft

    if apic:
        return (ft.init_apic_state2d, ft.step_apic2d, "step_apic2d",
                ("pos", "vel", "C", "u", "v", "phi"), "APIC")
    return ft.init_state2d, ft.step2d, "step2d", ("pos", "vel", "u", "v", "phi"), "FLIP"


def nonfinite_rows(t) -> list:
    return (~t.reshape(t.shape[0], -1).isfinite().all(1)).nonzero().flatten().tolist()


def check_sor_2d(table, results, captured, label, cfg) -> None:
    """The SOR kernel on a 2D step's (nx, ny, 1) inputs: bit for bit its
    plain version (check_kernels), a second launch bit-equal, and its
    counters: every fluid cell listed in its colour, 2 x 120 - 1 barriers."""
    from fluidsimulation_tpu_torch.ops import cuda_sor

    args = captured["sor"]
    if tuple(args[1].shape) != (cfg.nx, cfg.ny, 1):
        raise AssertionError(f"{label}: the SOR got phi of shape {tuple(args[1].shape)}")
    check_kernels(table, ("sor",), captured, label, results)
    p, counters = cuda_sor.sor_launch(*args)
    if not torch.equal(p, cuda_sor.sor_pressure(*args)):
        raise AssertionError(f"{label}: two SOR launches on the same inputs differ")
    n0, n1, barriers = counters.tolist()
    fluid = int((args[1] < 0).sum())
    if n0 + n1 != fluid or barriers != 2 * cfg.sor_iterations - 1:
        raise AssertionError(f"{label}: SOR counters {counters.tolist()}, expected {fluid} fluid "
                             f"cells and {2 * cfg.sor_iterations - 1} barriers")
    say(f"{label}: SOR on ({cfg.nx}, {cfg.ny}, 1): two launches bit-equal; fluid cells {n0} of "
        f"colour 0, {n1} of colour 1; {barriers} grid barriers")


def two_d_card_vs_cpu(table, results, apic: bool) -> dict:
    """D1 for one family: a 32^2 state stepped 3 times on the card and on
    the CPU; the SOR on the last card step's inputs; then the NaN rule: one
    NaN position, one step on the card and on the CPU."""
    import fluidsimulation_tpu_torch as ft

    init, step, _, fields, name = two_d_family(apic)
    cfg = ft.SimConfig2D(nx=TWO_D_SMALL, ny=TWO_D_SMALL, cells_per_meter=float(TWO_D_SMALL))
    label = f"phase D1 ({name} {TWO_D_SMALL}^2)"
    cpu_state = init(cfg, "cpu")
    card_state = cpu_state.to(DEVICE)
    check = LaunchCheck(label, two_d_launches())
    captured: dict = {}
    for _ in range(3):
        cpu_state = step(cpu_state, TWO_D_DT, cfg)
        with capture(captured):
            card_state = check.step(lambda: step(card_state, TWO_D_DT, cfg))
    torch.cuda.synchronize()
    check.totals()
    errs = {}
    for f in fields:
        d = float((getattr(card_state, f).cpu() - getattr(cpu_state, f)).abs().max())
        errs[f] = d
        limit = apic_bound(f, cfg)
        say(f"{label}: 3 steps, card vs CPU, {f}: max abs diff {d!r} (limit {limit!r})")
        if not d <= limit:
            raise AssertionError(f"{label}: {f} differs by {d} > {limit}")
    check_sor_2d(table, results, captured, label, cfg)

    bad = init(cfg, "cpu")
    bad.pos[BAD, 0] = float("nan")
    cpu_next = step(bad, TWO_D_DT, cfg)
    card_next = LaunchCheck(f"{label} NaN", two_d_launches()).step(
        lambda: step(bad.to(DEVICE), TWO_D_DT, cfg))
    torch.cuda.synchronize()
    # APIC's spline weights of a NaN distance are 0: its vel stays finite.
    expect = {"pos": [BAD], "vel": [] if apic else [BAD], "C": [BAD]}
    keep = torch.arange(cfg.num_particles) != BAD
    for f in fields:
        got, want = getattr(card_next, f).cpu(), getattr(cpu_next, f)
        if f in expect:
            rows = nonfinite_rows(got)
            if rows != expect[f] or nonfinite_rows(want) != expect[f]:
                raise AssertionError(f"{label} NaN: non-finite {f} rows {rows[:10]} (CPU "
                                     f"{nonfinite_rows(want)[:10]}), expected {expect[f]}")
            got, want = got[keep], want[keep]
        elif not bool(got.isfinite().all()):
            raise AssertionError(f"{label} NaN: non-finite values in {f}")
        d = float((got - want).abs().max())
        if not d <= apic_bound(f, cfg):
            raise AssertionError(f"{label} NaN: {f} differs from the CPU's by {d}")
    say(f"{label}: NaN rule: particle {BAD} with a NaN position, one step on the card: no raise, "
        f"only its rows non-finite ({', '.join(f for f in expect if f in fields and expect[f])}), "
        f"grids and phi finite, the rest within the bound of the CPU step")
    return errs


def decode_ppm(path: Path, width: int, height: int):
    """A binary PPM's pixels as an (H, W, 3) uint8 array; raises on a bad
    header or size."""
    import numpy as np

    data = path.read_bytes()
    header = f"P6\n{width} {height}\n255\n".encode()
    if not data.startswith(header) or len(data) != len(header) + width * height * 3:
        raise AssertionError(f"{path.name}: bad header or size")
    return np.frombuffer(data[len(header):], np.uint8).reshape(height, width, 3)


def two_d_demo(label, argv, apic, n_particles, n_steps, warmup, frames, card) -> dict:
    """app.demo.main(["--two-d", *argv]) with each step through the launch
    check (the SOR once, no other kernel), CUDA-event timed, the last
    step's kernel arguments captured; every field of the final state
    finite; the frames ``frames`` written and decoded (checkerboard greys
    and the particle blue only, blue present). Returns the path's
    numbers."""
    import numpy as np

    from fluidsimulation_tpu_torch.app import demo
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    _, _, step_attr, _, name = two_d_family(apic)
    check = LaunchCheck(label, two_d_launches())
    times, seen, captured = [], {}, {}

    def counted(_, orig, args):
        state, dt, cfg = args
        if check.steps == 0 and state.pos.shape[0] != n_particles:
            raise AssertionError(f"{label}: expected {n_particles} particles, "
                                 f"got {state.pos.shape[0]}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if check.steps == n_steps - 1:
            with capture(captured):
                out = check.step(lambda: orig(state, dt, cfg))
        else:
            out = check.step(lambda: orig(state, dt, cfg))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        seen["state"], seen["cfg"] = out, cfg
        return out

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        with hooked([("app.demo", step_attr, "step")], counted):
            rc = demo.main(["--two-d", "--device", "cuda", "--transfer", name.lower(),
                            "--steps", str(n_steps), *argv, "--out", out_dir])
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError(f"{label}: main returned {rc}")
        if check.steps != n_steps:
            raise AssertionError(f"{label}: ran {check.steps} steps, expected {n_steps}")
        launches = check.totals()
        written = sorted(p.name for p in Path(out_dir).iterdir())
        if written != frames:
            raise AssertionError(f"{label}: wrote {written}, expected {frames}")
        blue = []
        allowed = {(89, 89, 89), (166, 166, 166), (51, 102, 255)}
        for f in frames:
            px = decode_ppm(Path(out_dir) / f, WIDTH, HEIGHT)
            colours = {tuple(c) for c in np.unique(px.reshape(-1, 3), axis=0).tolist()}
            n_blue = int((px == (51, 102, 255)).all(-1).sum())
            if not colours <= allowed or n_blue == 0:
                raise AssertionError(f"{label}: {f} has colours {sorted(colours)[:5]}, "
                                     f"{n_blue} particle pixels")
            blue.append(n_blue)
    state, cfg = seen["state"], seen["cfg"]
    check_finite(label, state)
    step_ms = statistics.median(times[warmup:])
    say(f"{label}: {n_steps} steps of {cfg.nx}^2, {n_particles} particles; all fields finite; "
        f"frames {frames} decoded, particle pixels {blue}")
    say(f"{label}: median step {step_ms!r} ms over {len(times) - warmup} steps after {warmup} "
        f"warm-up (min {min(times[warmup:])!r}, max {max(times[warmup:])!r}); peak device "
        f"memory {peak} B ({peak / 2**30:.3f} GiB) on {card}")
    return {"step_ms": step_ms, "step_times": times, "peak_bytes": peak, "launches": launches,
            "frames": len(frames), "captured": captured, "cfg": cfg}


def time_sor_2d(label, captured, card) -> dict:
    """The SOR kernel on a 2D path's last inputs: device time under
    torch.profiler and by events, its plain version, its bound."""
    from fluidsimulation_tpu_torch.ops import cuda_sor

    args = captured["sor"]
    ms = device_ms(lambda: cuda_sor.sor_pressure(*args), 20)
    wall_ms = cuda_ms(lambda: cuda_sor.sor_pressure(*args), 20)
    plain_ms = cuda_ms(lambda: cuda_sor.sor_pressure_plain(*args), 5)
    b_ms, b_by = bound("sor", args)
    say(f"{label}: SOR kernel {ms!r} ms of device time ({wall_ms!r} ms by events, back to back), "
        f"plain {plain_ms!r} ms, bound {b_ms!r} ms ({b_by}) on {card}")
    return {"ms": ms, "events_ms": wall_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def two_d_phase(table, results, card) -> dict:
    """Phase D: the 2D family on the card (D1, D2, D3 of the docstring)."""
    out: dict = {"card_vs_cpu_32^2": {}, "step_ms": {}, "step_times": {}, "peak_bytes": {},
                 "launches": {}, "frames": {}, "sor": {}}
    for apic in (False, True):
        out["card_vs_cpu_32^2"][two_d_family(apic)[4]] = two_d_card_vs_cpu(table, results, apic)
    demo_frames = [f"frame2d_{i:05d}.ppm" for i in range(0, TWO_D_DEMO_STEPS, TWO_D_RENDER_EVERY)]
    for apic in (False, True):
        name = two_d_family(apic)[4]
        for key, label, argv, n, steps, warmup, frames in (
            (f"demo 64^2 {name}", f"phase D2 (demo 64^2 {name})",
             ["--render-every", str(TWO_D_RENDER_EVERY)], TWO_D_DEMO_PARTICLES,
             TWO_D_DEMO_STEPS, N_WARMUP, demo_frames),
            (f"{TWO_D_BIG}^2 {name}", f"phase D3 ({TWO_D_BIG}^2 {name})",
             ["--grid", str(TWO_D_BIG)], TWO_D_BIG_PARTICLES, TWO_D_BIG_STEPS, TWO_D_WARMUP, []),
        ):
            run = two_d_demo(label, argv, apic, n, steps, warmup, frames, card)
            check_sor_2d(table, results, run["captured"], label, run["cfg"])
            out["sor"][key] = time_sor_2d(label, run["captured"], card)
            for field in ("step_ms", "step_times", "peak_bytes", "launches", "frames"):
                out[field][key] = run[field]
    return out


def count_syncs(fn):
    """fn() once, under torch.cuda.set_sync_debug_mode("warn"): returns its
    result, the synchronizing calls torch reported and the renderer's own
    host reads (render/raytrace.py::_any) among them."""
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    reads = [0]

    def counted(label, orig, args):
        reads[0] += 1
        return orig(*args)

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, \
            hooked([("render.raytrace", "_any", "any")], counted):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    if syncs < reads[0]:
        raise AssertionError(f"render: torch reported {syncs} synchronizing calls, fewer than the "
                             f"renderer's {reads[0]} host reads")
    return out, syncs, reads[0]


def check_host_syncs(label: str, step, state, dt, cfg) -> None:
    """One step of ``step`` under torch.cuda.set_sync_debug_mode("warn")
    with the program's recording open: the synchronizing calls torch
    reports must be the step's ``sync`` counter (utils/trace.py), the
    count step.host_syncs reads."""
    from fluidsimulation_tpu_torch.utils import trace

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.recording() as rec:
                step(state, dt, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    warned = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    counted = rec.counts.get(0, {}).get(trace.SYNC, 0)
    if rec.steps != 1 or warned != counted:
        raise AssertionError(f"{label}: torch reported {warned} synchronizing calls in a step, "
                             f"the step's sync counter {counted} ({rec.steps} steps recorded)")
    say(f"{label}: one step, {warned} synchronizing calls, the step's sync counter {counted}")


def check_frame(label: str, img, shape) -> float:
    """The frame has the shape, is finite and is not flat as shown: the std
    of its values clipped to [0, 1], as write_ppm shows them, is > 0.01
    (the reference's garbage pixels, up to ~1e35, would set an unclipped
    std). Returns that std."""
    if tuple(img.shape) != shape:
        raise AssertionError(f"{label}: frame shape {tuple(img.shape)}, expected {shape}")
    if not bool(img.isfinite().all()):
        raise AssertionError(f"{label}: non-finite values in the frame")
    std = float(img.clamp(0.0, 1.0).double().std())
    if not std > 0.01:
        raise AssertionError(f"{label}: the shown frame's std {std} <= 0.01")
    return std


def time_frames(label, phi, band_rows, step_ms, card, extra=()):
    """FRAMES 800x600 frames of phi after one warm-up, CUDA-event timed;
    the host syncs and the peak device memory of one more frame; then each
    of ``extra`` (name, render_frame keywords) once. Returns the report."""
    from fluidsimulation_tpu_torch.render.camera import OrbitCamera
    from fluidsimulation_tpu_torch.render.raytrace import render_frame

    cam = OrbitCamera().frame(WIDTH, HEIGHT)

    def frame(**kw):
        return render_frame(phi, *cam, width=WIDTH, height=HEIGHT, **{"band_rows": band_rows, **kw})

    def timed(**kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        img = frame(**kw)
        end.record()
        torch.cuda.synchronize()
        return img, start.elapsed_time(end)

    first = frame()
    torch.cuda.synchronize()
    std = check_frame(label, first, (HEIGHT, WIDTH, 3))
    times = []
    for _ in range(FRAMES):
        img, ms = timed()
        if not torch.equal(img, first):
            raise AssertionError(f"{label}: two frames of the same phi differ")
        times.append(ms)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    img, syncs, reads = count_syncs(frame)
    peak = torch.cuda.max_memory_allocated() - base
    if not torch.equal(img, first):
        raise AssertionError(f"{label}: the frame under sync counting differs")
    ms = statistics.median(times)
    fps = 1e3 / (step_ms + ms)
    say(f"phase R [{label}]: {WIDTH}x{HEIGHT} band_rows={band_rows}: finite, shown std {std!r}; "
        f"median frame {ms!r} ms of {times!r} (CUDA events, "
        f"{FRAMES} after 1 warm-up); {syncs} host syncs a frame ({reads} of them the marches' "
        f"reads of 'any lane left'); peak device memory of a frame {peak} B above the {base} B "
        f"resident; sim_render_fps = 1 / (step {step_ms!r} ms + frame {ms!r} ms) = {fps!r} on {card}")
    out = {"ms": ms, "frame_ms": times, "host_syncs": syncs, "march_reads": reads,
           "peak_bytes": peak, "step_ms": step_ms, "sim_render_fps": fps}
    for name, kw in extra:
        img, ms = timed(**kw)
        std = check_frame(f"{label} {name}", img, (HEIGHT, WIDTH, 3))
        note = ""
        if set(kw) == {"band_rows"}:
            # Tiles change only which rays march together: the same bits.
            if not torch.equal(img, first):
                raise AssertionError(f"{label} {name}: the frame differs from the tiled one")
            note = ", bit-equal to the tiled frame"
        out[f"{name}_ms"] = ms
        say(f"phase R [{label}] {name}: one frame {ms!r} ms (CUDA events), finite, shown std "
            f"{std!r}{note} on {card}")
    return out


def card_vs_cpu_frame(dev, card) -> dict:
    """A 32^3 state stepped 3 times on the card; its frame on the card vs
    the same phi's frame on the CPU, both by the port."""
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.render.camera import OrbitCamera
    from fluidsimulation_tpu_torch.render.raytrace import quirk_pixels, render_frame

    cfg = ft.SimConfig(nx=SMALL_N, ny=SMALL_N, nz=SMALL_N, cells_per_meter=float(SMALL_N),
                       particles_per_cell_axis=1)
    state = ft.init_state(cfg, dev)
    for _ in range(3):
        state = ft.step(state, DT, cfg)
    w, h = SMALL_FRAME
    cam = OrbitCamera().frame(w, h)
    got = render_frame(state.phi, *cam, width=w, height=h).cpu()
    want = render_frame(state.phi.cpu(), *cam, width=w, height=h)
    check_frame("phase R card frame", got, (h, w, 3))
    keep = ~quirk_pixels(*cam, w, h)
    d = (got - want).abs()[keep]
    err, n_out = float(d.max()), int((d > FRAME_ATOL).sum())
    n_exact = int((got == want).all(-1).sum())
    say(f"phase R: {SMALL_N}^3 state after 3 card steps, {w}x{h} frame, card vs CPU: "
        f"{int((~keep).sum())} quirk pixels excluded; of {d.numel()} values {n_out} differ by "
        f"more than {FRAME_ATOL} (limit {FRAME_FRAC * d.numel()!r}), largest difference {err!r} "
        f"(limit {FRAME_MAX}); {n_exact} of {w * h} pixels bit-equal on {card}")
    if n_out > FRAME_FRAC * d.numel() or err > FRAME_MAX:
        raise AssertionError(f"phase R: card and CPU frames differ past the bound ({n_out} values "
                             f"past {FRAME_ATOL}, largest {err})")
    return {"max_abs_err": err, "values_past_atol": n_out, "values": d.numel(),
            "quirk_pixels": int((~keep).sum()), "pixels_bit_equal": n_exact}


def demo_with_frames(card) -> dict:
    """app.demo.main at 64^3 with --render-every 2 for 4 steps: two PPM
    frames of 800x600, every step through the launch check."""
    from fluidsimulation_tpu_torch.app import demo
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    steps, every = 4, 2
    check = LaunchCheck("phase R (demo with frames)")

    def counted(label, orig, args):
        return check.step(lambda: orig(*args))

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        t0 = time.perf_counter()
        with hooked([("app.demo", "step", "step")], counted):
            rc = demo.main(["--device", "cuda", "--steps", str(steps), "--render-every",
                            str(every), "--out", out_dir])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"demo with frames: main returned {rc}")
        check.totals()
        frames = sorted(Path(out_dir).glob("frame_*.ppm"))
        names = [f.name for f in frames]
        want = [f"frame_{i:05d}.ppm" for i in range(0, steps, every)]
        if names != want:
            raise AssertionError(f"demo with frames: wrote {names}, expected {want}")
        header = f"P6\n{WIDTH} {HEIGHT}\n255\n".encode()
        for f in frames:
            data = f.read_bytes()
            if not data.startswith(header) or len(data) != len(header) + WIDTH * HEIGHT * 3:
                raise AssertionError(f"demo with frames: {f.name} has a bad header or size")
    say(f"phase R: demo 64^3 ppc 2, {steps} steps with --render-every {every}: {len(frames)} PPM "
        f"frames of {WIDTH}x{HEIGHT}, headers and sizes right; {wall:.1f} s in all on {card}")
    return {"frames": len(frames), "steps": steps, "seconds": wall}


def render_phase(dev, main_phi, main_step_ms, demo_phi, demo_step_ms, card) -> dict:
    """Phase R: the renderer on the card."""
    out = {"card_vs_cpu_32^3": card_vs_cpu_frame(dev, card)}
    out["128^3 ppc 1"] = time_frames(
        f"{MAIN_N}^3 ppc 1", main_phi, 100, main_step_ms, card,
        extra=(("bounces1", {"bounces": 1}), ("bounces0", {"bounces": 0}),
               ("overstep1.5", {"overstep": 1.5}), ("untiled", {"band_rows": 0})))
    out["demo 64^3 ppc 2"] = time_frames("demo 64^3 ppc 2", demo_phi, 64, demo_step_ms, card,
                                         extra=(("untiled", {"band_rows": 0}),))
    out["demo with frames"] = demo_with_frames(card)
    return out

def parse_profile(label: str, text: str, profs: list, draw_steps) -> list:
    """The --profile tables and step lines the demo printed, held against
    the StageProfilers its steps returned (``profs``): each printed table
    is its profiler's table(), followed by the step's line. Returns one
    {mark: ms} a step, with the printed step time under "step_ms". Raises
    unless every stage mark is > 0, the marks JAX never times are 0, DRAW is
    > 0 on ``draw_steps`` only, and a step's stage marks and DRAW sum to no
    more than its printed step time, within that print's rounding (0.05
    ms)."""
    from fluidsimulation_tpu_torch.utils.profiling import MARKS, STAGE_MARKS

    lines = text.splitlines()
    heads = [i for i, line in enumerate(lines) if line.startswith("GPU time:\tA ")]
    if len(heads) != len(profs):
        raise AssertionError(f"{label}: {len(heads)} profile tables, {len(profs)} profiled steps")
    rows = []
    for step, (i, prof) in enumerate(zip(heads, profs)):
        if "\n".join(lines[i:i + 2]) != prof.table():
            raise AssertionError(f"{label} step {step}: the printed table is not the profiler's")
        found = re.match(rf"step {step}: ([0-9.]+) ms", lines[i + 2])
        if not found:
            raise AssertionError(f"{label} step {step}: no step line after the table")
        row = {m: 1e3 * prof.times[m] for m in MARKS}
        row["step_ms"] = float(found.group(1))
        zero = [m for m in STAGE_MARKS if not row[m] > 0]
        if zero:
            raise AssertionError(f"{label} step {step}: stage marks {zero} not > 0")
        if any(row[m] != 0.0 for m in JAX_ZERO_MARKS):
            raise AssertionError(f"{label} step {step}: a mark JAX never times is not 0: {row}")
        if (row["DRAW"] > 0) != (step in draw_steps):
            raise AssertionError(f"{label} step {step}: DRAW {row['DRAW']}, frames on steps "
                                 f"{list(draw_steps)}")
        stages = sum(row[m] for m in STAGE_MARKS)
        if stages + row["DRAW"] > row["step_ms"] + 0.05:
            raise AssertionError(f"{label} step {step}: stage marks {stages} ms + DRAW "
                                 f"{row['DRAW']} ms > step {row['step_ms']} ms")
        rows.append(row)
    return rows


def run_demo_captured(argv, sites, around) -> tuple[int, str]:
    """app.demo.main(argv) with ``sites`` hooked by ``around``; its standard
    output captured, then printed. Returns (its return code, its output)."""
    import contextlib
    import io

    from fluidsimulation_tpu_torch.app import demo
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), hooked(sites, around):
            rc = demo.main(argv)
    finally:
        sys.stdout.write(buf.getvalue())
        sys.stdout.flush()
    return rc, buf.getvalue()


def unprofiled_steps(transfer, steps, step_attr) -> list:
    """The demo's argv of profile_demo without --profile: the host time of
    each step call and the synchronize after it, in ms (the printed step
    time of a --profile step without a frame covers the same)."""
    times = []

    def timed(_, orig, args):
        t0 = time.perf_counter()
        out = orig(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        rc, _ = run_demo_captured(
            ["--device", "cuda", "--transfer", transfer, "--steps", str(steps), "--render-every",
             str(PROFILE_EVERY), "--width", str(SMALL_FRAME[0]), "--height", str(SMALL_FRAME[1]),
             "--out", out_dir], [("app.demo", step_attr, "step")], timed)
    if rc != 0 or len(times) != steps:
        raise AssertionError(f"unprofiled demo ({transfer}): rc {rc}, {len(times)} steps")
    return times


def profile_demo(card) -> dict:
    """P1: the demo at its defaults with --profile, FLIP for PROFILE_STEPS
    steps and APIC for PROFILE_APIC_STEPS, a 160x120 frame every
    PROFILE_EVERY steps; every profiled step through the launch check of
    its family (phases 5 and A); the tables checked (parse_profile).
    Before each, the same run without --profile (unprofiled_steps): the
    cost of --profile is the median printed step time against the median
    unprofiled step, over the steps after the first that draw no frame.
    Returns each mark's median over the steps, and the step times."""
    from fluidsimulation_tpu_torch.utils.profiling import MARKS

    out = {}
    for transfer, steps, attr, step_attr, expect in (
        ("flip", PROFILE_STEPS, "profile_step", "step", None),
        ("apic", PROFILE_APIC_STEPS, "profile_step_apic", "step_apic", apic_launches()),
    ):
        plain = unprofiled_steps(transfer, steps, step_attr)
        label = f"phase P1 (--profile, {transfer})"
        check, profs = LaunchCheck(label, expect), []

        def profiled(_, orig, args):
            out = check.step(lambda: orig(*args))
            profs.append(out[1])
            return out

        build = Path(__file__).resolve().parent / "build"
        build.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=build) as out_dir:
            rc, text = run_demo_captured(
                ["--device", "cuda", "--profile", "--transfer", transfer, "--steps", str(steps),
                 "--render-every", str(PROFILE_EVERY), "--width", str(SMALL_FRAME[0]),
                 "--height", str(SMALL_FRAME[1]), "--out", out_dir],
                [("app.demo", attr, "profile")], profiled)
        if rc != 0:
            raise AssertionError(f"{label}: main returned {rc}")
        if check.steps != steps:
            raise AssertionError(f"{label}: {check.steps} profiled steps, expected {steps}")
        launches = check.totals()
        rows = parse_profile(label, text, profs, range(0, steps, PROFILE_EVERY))
        medians = {m: statistics.median(r[m] for r in rows) for m in MARKS}
        bare = [i for i in range(1, steps) if i % PROFILE_EVERY]
        profiled_ms = statistics.median(rows[i]["step_ms"] for i in bare)
        plain_ms = statistics.median(plain[i] for i in bare)
        say(f"{label}: {steps} tables checked in {time.perf_counter() - t0:.1f} s; median ms a "
            "mark: " + ", ".join(f"{m}={v!r}" for m, v in medians.items()) + f"; steps {bare} "
            f"without a frame: profiled {profiled_ms!r} ms, unprofiled {plain_ms!r} ms (median) "
            f"on {card}")
        out[transfer] = {"mark_median_ms": medians, "step_ms": [r["step_ms"] for r in rows],
                         "unprofiled_step_ms": plain, "profiled_median_ms": profiled_ms,
                         "unprofiled_median_ms": plain_ms, "launches": launches}
    return out


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a JPEG's first start-of-frame marker."""
    i = 2
    while i + 9 < len(data):
        if data[i] != 0xFF:
            raise AssertionError("JPEG: lost marker sync")
        marker, length = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        if marker in (0xC0, 0xC1, 0xC2):
            width, height = data[i + 7:i + 9], data[i + 5:i + 7]
            return int.from_bytes(width, "big"), int.from_bytes(height, "big")
        i += 2 + length
    raise AssertionError("JPEG: no start-of-frame marker")


def decode_png(data: bytes):
    """An RGB8 PNG of filter-0 scanlines (app/liveview.py::_encode_png) as
    an (H, W, 3) uint8 array, each chunk's CRC checked; raises on anything
    else."""
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("PNG: bad signature")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        length, tag = int.from_bytes(data[pos:pos + 4], "big"), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = int.from_bytes(data[pos + 8 + length:pos + 12 + length], "big")
        if crc != zlib.crc32(tag + body):
            raise AssertionError(f"PNG: bad CRC in {tag!r}")
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
            if tuple(body[8:10]) != (8, 2):
                raise AssertionError(f"PNG: not RGB8 ({tuple(body[8:10])})")
            size = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError("PNG: a scanline filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def serve_client(base: str, got: dict) -> None:
    """The live view's client: wait for the page, read it and one /stream
    part, post 'o 10 -5' and '+', read two more parts and post 'q'.
    Whatever it raises is kept in got["error"] for the main thread."""
    import urllib.error
    import urllib.request

    # No proxy from the environment: every request is to 127.0.0.1.
    urlopen = urllib.request.build_opener(urllib.request.ProxyHandler({})).open
    try:
        deadline = time.monotonic() + SERVE_TIMEOUT
        while True:
            try:
                got["page"] = urlopen(f"{base}/", timeout=30).read()
                break
            except urllib.error.URLError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        resp = urlopen(f"{base}/stream", timeout=60)

        def part():
            head = b""
            while not head.endswith(b"\r\n\r\n"):
                head += resp.read(1)
            length = int(re.search(rb"Content-Length: (\d+)", head).group(1))
            return head, resp.read(length)

        def post(c):
            urlopen(f"{base}/cmd?c={c}", timeout=30).read()
            got.setdefault("posted", []).append(c)

        got["head"], got["part"] = part()
        post("o%2010%20-5")
        post("%2B")
        # Two frames on, a step has begun after the '+' was queued, so it
        # ran at the doubled rate before the 'q'.
        part()
        part()
        resp.close()
        post("q")
    except Exception as e:  # handed to the main thread, which raises it
        got["error"] = e


def serve_demo(label, argv, step_attr, expect, frame_glob, rate_dts, card,
               hide_pillow=False) -> dict:
    """P2: the demo with --serve on a free port, a 160x120 frame a step, and
    a client thread (serve_client); every step through the launch check.
    With ``hide_pillow`` PIL cannot be imported during the run, so the
    view's zlib PNG is what it streams. Raises unless the client read the
    page and a frame (a PNG decoding to a PPM the demo wrote, or a JPEG of
    160x120), the '+' doubled dt, and 'q' ended the run before SERVE_STEPS
    steps, with main returning 0."""
    import threading

    import numpy as np

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    check = LaunchCheck(label, expect)
    dts, got = [], {}

    def counted(_, orig, args):
        dts.append(args[1])
        return check.step(lambda: orig(*args))

    client = threading.Thread(target=serve_client, args=(f"http://127.0.0.1:{port}", got),
                              daemon=True)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    saved_pil = sys.modules.get("PIL", False)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        if hide_pillow:
            sys.modules["PIL"] = None
        client.start()
        try:
            rc, _ = run_demo_captured(
                ["--device", "cuda", *argv, "--render-every", "1", "--width", str(SMALL_FRAME[0]),
                 "--height", str(SMALL_FRAME[1]), "--steps", str(SERVE_STEPS), "--serve",
                 str(port), "--out", out_dir],
                [("app.demo", step_attr, "step")], counted)
        finally:
            client.join(SERVE_TIMEOUT)
            if hide_pillow:
                if saved_pil is False:
                    del sys.modules["PIL"]
                else:
                    sys.modules["PIL"] = saved_pil
        if client.is_alive():
            raise AssertionError(f"{label}: the client did not finish in {SERVE_TIMEOUT} s")
        if "error" in got:
            raise AssertionError(f"{label}: the client failed: {got['error']!r}")
        if rc != 0:
            raise AssertionError(f"{label}: main returned {rc}")
        launches = check.totals()
        if not check.steps < SERVE_STEPS:
            raise AssertionError(f"{label}: ran {check.steps} steps; 'q' did not end the run")
        if b"/stream" not in got["page"]:
            raise AssertionError(f"{label}: the page has no /stream")
        w, h = SMALL_FRAME
        part, match = got["part"], None
        if b"Content-Type: image/png" in got["head"]:
            kind, pixels = "png", decode_png(part)
            if pixels.shape != (h, w, 3):
                raise AssertionError(f"{label}: PNG of shape {pixels.shape}")
            for f in sorted(Path(out_dir).glob(frame_glob)):
                if np.array_equal(decode_ppm(f, w, h), pixels):
                    match = f.name
                    break
            if match is None:
                raise AssertionError(f"{label}: the streamed PNG equals no frame the demo wrote")
        elif b"Content-Type: image/jpeg" in got["head"]:
            kind = "jpeg"
            if part[:2] != b"\xff\xd8" or jpeg_size(part) != (w, h):
                raise AssertionError(f"{label}: not a {w}x{h} JPEG")
        else:
            raise AssertionError(f"{label}: part headers {got['head']!r}")
        frames = len(list(Path(out_dir).glob(frame_glob)))
    slow, fast = rate_dts
    if dts[0] != slow or fast not in dts or dts[dts.index(fast) - 1] != slow:
        raise AssertionError(f"{label}: dts {dts[:8]}, expected {slow} then {fast} after '+'")
    seconds = time.perf_counter() - t0
    say(f"{label}: port {port}: the page, one {kind} part ({len(part)} B"
        f"{', equal to ' + match if match else ''}), posted {got['posted']}; dt {slow!r} -> "
        f"{fast!r} after '+'; 'q' ended the run after {check.steps} of {SERVE_STEPS} steps, "
        f"{frames} frames written; {seconds:.1f} s on {card}")
    return {"port": port, "image": kind, "part_bytes": len(part), "equal_to": match,
            "steps": check.steps, "frames": frames, "launches": launches, "seconds": seconds}


def app_phase(card) -> dict:
    """Phase P: P1 (--profile) and P2 (--serve, 3D and --two-d)."""
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.solver.step3d import clamp_dt

    out = {"profile": profile_demo(card)}
    demo_cfg = ft.SimConfig()  # the demo's 64^3
    out["serve_3d"] = serve_demo(
        "phase P2 (--serve, 64^3)", [], "step", None, "frame_*.ppm",
        (clamp_dt(demo_cfg, DT, 0.5), clamp_dt(demo_cfg, DT, 1.0)), card)
    out["serve_2d"] = serve_demo(
        "phase P2 (--serve, --two-d 64^2)", ["--two-d"], "step2d", two_d_launches(),
        "frame2d_*.ppm", (DT * 0.5, DT * 1.0), card, hide_pillow=True)
    out["steps_taken"] = {"serve_3d": out["serve_3d"]["steps"],
                          "serve_2d": out["serve_2d"]["steps"]}
    return out


def big_cfg(ppc: int):
    import fluidsimulation_tpu_torch as ft

    return ft.SimConfig(nx=BIG_N, ny=BIG_N, nz=BIG_N, cells_per_meter=float(BIG_N),
                        particles_per_cell_axis=ppc)


def big_state(label, init, ppc):
    """The 256^3 dam break at ppc on the card, the peak counter reset
    before it; raises on a wrong particle count."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = big_cfg(ppc)
    state = init(cfg, DEVICE)
    if state.pos.shape[0] != BIG_PARTICLES[ppc]:
        raise AssertionError(f"{label}: expected {BIG_PARTICLES[ppc]} particles, got "
                             f"{state.pos.shape[0]}")
    return cfg, state


def fold_errors(results: dict, kernels: dict) -> None:
    """Every kernel error of phase B also goes to the report's maximum."""
    for key, entry in kernels.items():
        top = results.setdefault(key, {"max_abs_err": 0.0})
        top["max_abs_err"] = max(top["max_abs_err"], entry["max_abs_err"])


def big_phase(table, results, card) -> dict:
    """Phase B: the 256^3 dam break. B1: FLIP at ppc 1, N_WARMUP + 8 steps,
    kernels 1-5 vs their plain versions on the last step's inputs, timed,
    with the SOR's counters; B2: APIC at ppc 1, 1 + 4 steps; B3: the soak,
    ppc 2 at dt 1/240, 20 guarded steps, each healthy, then P2G's ppc >= 2
    path vs its plain version on the last step's inputs. Every step through
    the launch check of its family."""
    import fluidsimulation_tpu_torch as ft

    out = {}
    ppc1_keys = ("seed", "sweep", "p2g", "sor", "g2p")

    t0 = time.perf_counter()
    label = f"phase B1 (FLIP {BIG_N}^3 ppc 1)"
    cfg, state = big_state(label, ft.init_state, 1)
    y0 = float(state.pos[:, 1].mean())
    check, captured = LaunchCheck(label), {}
    state, times = timed_steps(check, N_WARMUP + BIG_FLIP_STEPS, state, DT, cfg, captured)
    launches = check.totals()
    check_finite(label, state)
    y1 = float(state.pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"{label}: centre of mass did not fall ({y0} -> {y1})")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    say(f"{label}: {BIG_PARTICLES[1]} particles, dt={DT!r}: all fields finite, mean y {y0!r} -> "
        f"{y1!r}; median step {step_ms!r} ms over {len(times)} steps after {N_WARMUP} warm-up "
        f"(min {min(times)!r}, max {max(times)!r}); peak device memory {peak} B "
        f"({peak / 2**30:.3f} GiB) on {card}")
    del state
    kernels: dict = {}
    check_kernels(table, ppc1_keys, captured, f"{BIG_N}^3 ppc 1", kernels, timed=ppc1_keys,
                  reported=ppc1_keys)
    sweep_sor_details(captured, f"{BIG_N}^3 ppc 1", card)
    del captured
    fold_errors(results, kernels)
    seconds = time.perf_counter() - t0
    say(f"{label}: {seconds:.1f} s")
    out["B1"] = {"step_ms": step_ms, "step_times": times, "peak_bytes": peak,
                 "launches": launches, "kernels": kernels, "seconds": seconds}

    t0 = time.perf_counter()
    label = f"phase B2 (APIC {BIG_N}^3 ppc 1)"
    cfg, state = big_state(label, ft.init_apic_state, 1)
    y0 = float(state.pos[:, 1].mean())
    check = LaunchCheck(label, apic_launches())
    state, times = timed_steps(check, BIG_APIC_WARMUP + BIG_APIC_STEPS, state, DT, cfg, {},
                               step=ft.step_apic, warmup=BIG_APIC_WARMUP)
    launches = check.totals()
    check_finite(label, state)
    y1 = float(state.pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"{label}: centre of mass did not fall ({y0} -> {y1})")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    del state
    seconds = time.perf_counter() - t0
    say(f"{label}: {BIG_PARTICLES[1]} particles: all fields finite, mean y {y0!r} -> {y1!r}; "
        f"median step {step_ms!r} ms over {len(times)} steps after {BIG_APIC_WARMUP} warm-up "
        f"(min {min(times)!r}, max {max(times)!r}); peak device memory {peak} B "
        f"({peak / 2**30:.3f} GiB); {seconds:.1f} s on {card}")
    out["B2"] = {"step_ms": step_ms, "step_times": times, "peak_bytes": peak,
                 "launches": launches, "seconds": seconds}

    t0 = time.perf_counter()
    label = f"phase B3 (soak {BIG_N}^3 ppc 2)"
    cfg, state = big_state(label, ft.init_state, 2)
    setup = time.perf_counter() - t0
    y0 = float(state.pos[:, 1].mean())
    say(f"{label}: {BIG_PARTICLES[2]} particles, dt={SOAK_DT!r}, {SOAK_STEPS} guarded steps; "
        f"set-up {setup:.1f} s")
    check, captured, times, trace = LaunchCheck(label), {}, [], []
    for i in range(SOAK_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == SOAK_STEPS - 1:
            with capture(captured):
                state, healthy = check.step(lambda: ft.step_guarded(state, SOAK_DT, cfg))
        else:
            state, healthy = check.step(lambda: ft.step_guarded(state, SOAK_DT, cfg))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        if not bool(healthy):
            raise AssertionError(f"{label}: step {i} is not healthy")
        if (i + 1) % SOAK_EVERY == 0:
            vmax = float(state.vel.abs().max())  # scripts/soak.py's |v|max
            ymean = float(state.pos[:, 1].mean())
            trace.append({"step": i + 1, "vmax": vmax, "mean_y": ymean})
            say(f"{label}: step {i + 1}: healthy, |v|max {vmax!r} m/s (largest component), "
                f"mean y {ymean!r} m")
    launches = check.totals()
    check_finite(label, state)
    if not trace[-1]["mean_y"] < y0:
        raise AssertionError(f"{label}: centre of mass did not fall "
                             f"({y0} -> {trace[-1]['mean_y']})")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times[N_WARMUP:])
    say(f"{label}: healthy on all {SOAK_STEPS} steps, all fields finite; median step {step_ms!r} "
        f"ms over {SOAK_STEPS - N_WARMUP} steps after {N_WARMUP} warm-up (min "
        f"{min(times[N_WARMUP:])!r}, max {max(times[N_WARMUP:])!r}); peak device memory {peak} B "
        f"({peak / 2**30:.3f} GiB) on {card}")
    del state
    torch.cuda.empty_cache()
    kernels = {}
    plain_oom = None
    try:
        check_kernels(table, ("p2g2",), captured, f"{BIG_N}^3 ppc 2", kernels, timed=("p2g2",),
                      reported=("p2g2",))
    except torch.cuda.OutOfMemoryError as e:
        # The plain scatter's temporaries do not fit beside the inputs:
        # phase 6 holds the kernel at 128^3 ppc 2 instead.
        plain_oom = str(e).splitlines()[0]
        say(f"{label}: P2G's plain version does not fit at {BIG_N}^3 ppc 2 ({plain_oom}); the "
            "kernel is held against it at 128^3 ppc 2 (phase 6)")
    del captured
    fold_errors(results, kernels)
    seconds = time.perf_counter() - t0
    say(f"{label}: {seconds:.1f} s")
    out["B3"] = {"step_ms": step_ms, "step_times": times, "peak_bytes": peak,
                 "launches": launches, "trace": trace, "kernels": kernels,
                 "plain_out_of_memory": plain_oom, "setup_seconds": setup, "seconds": seconds}
    return out


def multi_launches(family: str) -> dict:
    """Kernel symbol -> launches a rank makes in one multi-rank step: the
    pass, P2G and the FLIP gather on its slab (P2G and the gather not in
    APIC), the y/z sweeps in 8 calls, the 8 relayed x-sweeps, 2 x 100 SOR
    half-updates; fst_sor and the pack never."""
    flip = family == "flip"
    return {"fst_neighborhood_pass": 1, "fst_sweeps": 8, "fst_sweep_x_carry": 8,
            "fst_p2g": int(flip), "fst_sor": 0, "fst_sor_half": 200,
            "fst_g2p_flip": int(flip), "fst_pack_mac3_combined": 0}


def multi_held(label: str, got: dict, want, family: str, cfg) -> dict:
    """The gathered multi-rank state against the one-device state on the
    card (MULTI_FLIP_BOUNDS, apic_bound)."""
    bounds, rest = MULTI_FLIP_BOUNDS
    diffs = {}
    for name, arr in got.items():
        d = float((torch.from_numpy(arr) - getattr(want, name).cpu()).abs().max())
        limit = apic_bound(name, cfg) if family == "apic" else bounds.get(name, rest)
        if not d <= limit:
            raise AssertionError(f"{label}: {name} differs from the one-device step by {d} > {limit}")
        diffs[name] = d
    say(f"{label}: vs the one-device step on the card, max abs diff: "
        + ", ".join(f"{k} {v!r}" for k, v in diffs.items()))
    return diffs


def multi_steps(label: str, res: list, family: str, ref, n_steps: int, cfg) -> dict:
    """Phase M's checks of one multi-rank run: no particle dropped, each
    rank's launches every step as expected, the state within the bounds;
    prints each rank's launches and step times."""
    want = multi_launches(family)
    for r in res:
        if any(r["dropped"]):
            raise AssertionError(f"{label}: rank {r['rank']} dropped {r['dropped']}")
        for i, got in enumerate(r["launches"]):
            wanted = {k: v for k, v in want.items() if k in got}
            if got != wanted:
                raise AssertionError(f"{label}: rank {r['rank']} step {i} launched {got}, "
                                     f"expected {wanted}")
        say(f"{label} rank {r['rank']}: launches per step {r['launches'][-1]}; collectives per "
            f"step {r['calls'][-1]}; step ms {r['ms']!r}")
    step_ms = [max(r["ms"][i] for r in res) for i in range(n_steps)]
    diffs = multi_held(label, res[0]["state"], ref, family, cfg)
    return {"step_ms": step_ms, "max_abs_diff": diffs, "launches_per_step": res[0]["launches"][-1],
            "calls_per_step": [r["calls"][-1] for r in res]}


def one_device(family: str, cfg, n_steps: int, dev):
    """The one-device steps on the card from the dam break without k1 (the
    multi-rank step runs advection uncached)."""
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.parallel.runs import whole_state

    state = whole_state(family, cfg, dev)
    fn = ft.step_apic if family == "apic" else ft.step
    for _ in range(n_steps):
        state = fn(state, DT, cfg)
    torch.cuda.synchronize()
    return state


def multi_entries(inputs: dict, res: list, results: dict, card: str) -> None:
    """The two slab entries on rank 1's last inputs, here alone on the card:
    against their plain versions (bit for bit), timed, bounded; the ranks'
    own checks folded into the error."""
    import numpy as np

    from fluidsimulation_tpu_torch.ops import cuda_sor, cuda_sweep

    dev = torch.device(DEVICE)

    def on_card(args):
        return [torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a for a in args]

    cases = {
        "sweep_x": (cuda_sweep.sweep_x_carry, cuda_sweep.sweep_x_carry_plain,
                    on_card(inputs["carry"]), "sweep_x_carry"),
        "sor_half": (cuda_sor.sor_half, cuda_sor.sor_half_plain, on_card(inputs["half"]),
                     "sor_half"),
    }
    for key, (kernel, plain, args, name) in cases.items():
        if key == "sor_half":
            p0 = args[1]
            got = kernel(args[0], p0.clone(), *args[2:])
            want = plain(args[0], p0.clone(), *args[2:])
            pairs = [(got, want)]
            run_k = lambda: kernel(args[0], p0.clone(), *args[2:])  # noqa: E731
            run_p = lambda: plain(args[0], p0.clone(), *args[2:])  # noqa: E731
        else:
            pairs = list(zip(kernel(*args), plain(*args)))
            run_k = lambda: kernel(*args)  # noqa: E731
            run_p = lambda: plain(*args)  # noqa: E731
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in pairs)
        if not all(torch.equal(g, w) for g, w in pairs):
            raise AssertionError(f"phase M {name}: not bit-exact vs its plain version ({err})")
        rank_errs = [r["entries"][name] for r in res]
        if not all(exact for _, exact in rank_errs):
            raise AssertionError(f"phase M {name}: a rank's check not bit-exact: {rank_errs}")
        err = max([err] + [e for e, _ in rank_errs])
        ms = device_ms(run_k, 20)
        plain_ms = cuda_ms(run_p, 5)
        b_ms, b_by = bound(key, args)
        results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by}
        say(f"phase M {name} on rank 1's last inputs (shape {tuple(args[1].shape)}), alone on the "
            f"card: bit-exact vs its plain version (every rank's check too), kernel {ms!r} ms of "
            f"device time, plain {plain_ms!r} ms, bound {b_ms!r} ms ({b_by}) on {card}")


def multi_phase(results: dict, card: str) -> dict:
    """Phase M: the multi-rank family (parallel/, render/sharded.py) over
    MULTI_RANKS gloo ranks sharing the card, each rank's slab on the hand
    kernels; then a world of one NCCL rank."""
    import numpy as np

    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.ops.cuda_sor import sor_pressure
    from fluidsimulation_tpu_torch.ops.project import compute_diag, compute_rhs
    from fluidsimulation_tpu_torch.parallel import comm, runs
    from fluidsimulation_tpu_torch.render.camera import OrbitCamera
    from fluidsimulation_tpu_torch.render.raytrace import render

    t_all = time.perf_counter()
    dev = torch.device(DEVICE)
    d = MULTI_RANKS
    staging = ("point-to-point planes staged through host buffers (gloo's send/recv take no "
               "CUDA tensor: comm.GLOO_TAKES_CUDA); all_gather and all_reduce take the CUDA "
               "tensors")
    say(f"phase M: {d} ranks, backend gloo, all on the one card ({card}): NCCL refuses two "
        f"ranks of one communicator on one card; {staging}. Times below are {d} ranks sharing "
        f"one H100, not a speed across cards")
    out = {"ranks": d, "backend": "gloo", "device": "one card shared", "staging": staging}
    main = ft.SimConfig(nx=MAIN_N, ny=MAIN_N, nz=MAIN_N, cells_per_meter=float(MAIN_N),
                        particles_per_cell_axis=1)
    demo = ft.SimConfig(nx=MULTI_DEMO_N, ny=MULTI_DEMO_N, nz=MULTI_DEMO_N,
                        cells_per_meter=float(MULTI_DEMO_N), particles_per_cell_axis=2)
    if main.num_particles != MAIN_PARTICLES or demo.num_particles != DEMO_PARTICLES:
        raise AssertionError("phase M: unexpected particle counts")
    ref = one_device("flip", main, MULTI_FLIP_STEPS, dev)

    t0 = time.perf_counter()
    with comm.Ranks(d, "gloo", "cuda") as ranks:
        say(f"phase M: {d} ranks up in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        res = m1 = ranks.run(runs.halo_run, "flip", main, MULTI_FLIP_STEPS, DT,
                             check_entries=True, inputs_rank=1)
        label = (f"phase M1 (FLIP halo step, {MAIN_N}^3 ppc 1, {MAIN_PARTICLES} particles, "
                 f"{MAIN_PARTICLES // d} a rank, slabx {MAIN_N // d})")
        out["M1"] = multi_steps(label, res, "flip", ref, MULTI_FLIP_STEPS, main)
        out["M1"]["launches"] = {k: sum(sum(step[k] for step in r["launches"]) for r in res)
                                 for k in res[0]["launches"][0]}
        for r in res:
            say(f"{label} rank {r['rank']}: new entries vs their plain versions on its last "
                f"inputs: {r['entries']}")
        inputs = res[1]["inputs"]
        out["M1"]["seconds"] = time.perf_counter() - t0
        say(f"{label}: median step {statistics.median(out['M1']['step_ms'])!r} ms (slowest rank "
            f"a step), {d} ranks sharing one card; {out['M1']['seconds']:.1f} s")

        t0 = time.perf_counter()
        aref = one_device("apic", main, MULTI_APIC_STEPS, dev)
        again = one_device("apic", main, MULTI_APIC_STEPS, dev)
        noise = {f.name: float((getattr(again, f.name) - getattr(aref, f.name)).abs().max())
                 for f in dataclasses.fields(aref)}
        say(f"phase M2: two one-device APIC runs on the card differ by (atomics): {noise}")
        res = ranks.run(runs.halo_run, "apic", main, MULTI_APIC_STEPS, DT)
        out["M2"] = multi_steps(f"phase M2 (APIC halo step, {MAIN_N}^3 ppc 1)", res, "apic",
                                aref, MULTI_APIC_STEPS, main)
        out["M2"]["one_device_run_to_run"] = noise
        del aref, again
        out["M2"]["seconds"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dref = one_device("flip", demo, MULTI_DEMO_STEPS, dev)
        res = ranks.run(runs.halo_run, "flip", demo, MULTI_DEMO_STEPS, DT)
        out["M3"] = multi_steps(f"phase M3 (FLIP halo step, demo {MULTI_DEMO_N}^3 ppc 2, "
                                f"{DEMO_PARTICLES} particles)", res, "flip", dref,
                                MULTI_DEMO_STEPS, demo)
        del dref
        out["M3"]["seconds"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        diag = compute_diag(main, ref.phi)
        b = compute_rhs(main, ref.u, ref.v, ref.w, DT)
        want = sor_pressure(main, ref.phi, diag, b).cpu().numpy()
        res = ranks.run(runs.sor_run, main, *(t.cpu().numpy() for t in (ref.phi, diag, b)),
                        repeats=3)
        err = float(np.abs(res[0]["p"] - want).max())
        if not err <= 1e-5:
            raise AssertionError(f"phase M4: the halo SOR differs from fst_sor by {err}")
        sor_ms = [max(r["ms"][i] for r in res) for i in range(3)]
        out["M4"] = {"max_abs_diff": err, "ms": sor_ms, "launches": res[0]["launches"],
                     "calls": res[0]["calls"]}
        say(f"phase M4 (halo SOR, {MAIN_N}^3, 100 iterations): max abs diff vs fst_sor {err!r}; "
            f"a rank's launches {res[0]['launches']['fst_sor_half']} of fst_sor_half and "
            f"{res[0]['calls']['exchange_x']} exchanges; {sor_ms!r} ms a solve (slowest rank), "
            f"{d} ranks sharing one card; {time.perf_counter() - t0:.1f} s on {card}")

        t0 = time.perf_counter()
        cam = OrbitCamera().frame(WIDTH, HEIGHT)
        res = ranks.run(runs.render_run, ref.phi.cpu().numpy(), cam, WIDTH, HEIGHT, 100, 100)
        render_ms = max(r["ms"][0] for r in res)
        start = time.perf_counter()
        tiled = render(ref.phi, *cam, WIDTH, HEIGHT, band_rows=100, band_cols=100).cpu().numpy()
        tiled_ms = 1e3 * (time.perf_counter() - start)
        if not np.array_equal(res[0]["image"], tiled):
            raise AssertionError("phase M5: the sharded frame is not the tiled frame bit for bit")
        out["M5"] = {"ms": render_ms, "tiled_one_process_ms": tiled_ms, "bit_equal": True}
        tiles = -(-WIDTH // 100) * -(-HEIGHT // 100)
        say(f"phase M5 (sharded render, {WIDTH}x{HEIGHT}, {tiles} tiles of 100x100 over {d} ranks): "
            f"bit for bit the tiled frame; {render_ms!r} ms a frame ({d} ranks sharing one card) "
            f"beside {tiled_ms!r} ms for the tiled frame in one process; "
            f"{time.perf_counter() - t0:.1f} s on {card}")

    multi_entries(inputs, m1, results, card)
    out["M1"]["new_entries"] = {k: results[k] for k in ("sweep_x", "sor_half")}
    t0 = time.perf_counter()
    res = comm.run_ranks(runs.halo_run, 1, "nccl", "cuda", "flip", main, MULTI_FLIP_STEPS, DT)
    out["M6"] = multi_steps(f"phase M6 (one NCCL rank, FLIP halo step, {MAIN_N}^3 ppc 1)", res,
                            "flip", ref, MULTI_FLIP_STEPS, main)
    out["M6"]["seconds"] = time.perf_counter() - t0
    del ref
    out["seconds"] = time.perf_counter() - t_all
    say(f"phase M: {out['seconds']:.1f} s")
    return out


def main() -> int:
    # Phase 0: the card.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card")
    card = card_line()
    say(f"phase 0: card (nvidia-smi name, power.limit): {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("phase 0: TF32 off (torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False)")

    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch import _build

    dev = torch.device(DEVICE)

    # Phase 1: build the kernels from csrc/.
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    say(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry" in line or "Used" in line:
            say(f"phase 1: ptxas: {line.split('info    :')[-1].strip()}")

    table = kernel_table()
    ppc1_keys = ("seed", "sweep", "p2g", "sor", "g2p")
    results: dict = {}

    # Phase 2 at 32^3: a few CPU steps, then one step on the card, recording
    # what each kernel received; phase 4 reuses this step.
    small = ft.SimConfig(nx=SMALL_N, ny=SMALL_N, nz=SMALL_N, cells_per_meter=float(SMALL_N),
                         particles_per_cell_axis=1)
    cpu_state = ft.init_state(small, "cpu")
    for _ in range(3):
        cpu_state = ft.step(cpu_state, DT, small)
    card_state = cpu_state.to(dev)
    captured_small: dict = {}
    with capture(captured_small):
        card_next = ft.step(card_state, DT, small)
    torch.cuda.synchronize()
    check_kernels(table, ppc1_keys, captured_small, f"{SMALL_N}^3", results)

    # Phase 3: the main path, 128^3 dam break.
    cfg = ft.SimConfig(nx=MAIN_N, ny=MAIN_N, nz=MAIN_N, cells_per_meter=float(MAIN_N),
                       particles_per_cell_axis=1)
    state = ft.init_state(cfg, dev)
    torch.cuda.synchronize()
    n = state.pos.shape[0]
    say(f"phase 3: {cfg.nx}x{cfg.ny}x{cfg.nz} dam break, {n} particles, dt={DT!r}, {N_STEPS} steps")
    if n != MAIN_PARTICLES:
        raise AssertionError(f"expected {MAIN_PARTICLES} particles, got {n}")
    y0 = float(state.pos[:, 1].mean())
    check = LaunchCheck("phase 3 (128^3 ppc 1)")
    captured_big: dict = {}
    state, times = timed_steps(check, N_STEPS, state, DT, cfg, captured_big)
    launches = check.totals()
    check_finite("phase 3", state)
    m = torch.tensor([cfg.nx, cfg.ny, cfg.nz], dtype=torch.float32, device=dev)
    lo, hi = -0.4 / m, 1.0 - 0.6 / m
    if not bool(((state.pos >= lo - 1e-6) & (state.pos <= hi + 1e-6)).all()):
        raise AssertionError("phase 3: particles left the advection clamp box")
    y1 = float(state.pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"phase 3: centre of mass did not fall ({y0} -> {y1})")
    step_ms = statistics.median(times)
    say(f"phase 3: all fields finite, positions in the clamp box, mean y {y0!r} -> {y1!r}")
    say(f"phase 3: median step {step_ms!r} ms over {len(times)} steps after {N_WARMUP} warm-up "
        f"(min {min(times)!r}, max {max(times)!r}) on {card}")

    # Phase 2 at 128^3, on the inputs of the last main-path step; phase 7
    # on its final state.
    check_kernels(table, ppc1_keys, captured_big, f"{MAIN_N}^3", results, timed=ppc1_keys,
                  reported=ppc1_keys)
    sweep_sor_details(captured_big, f"{MAIN_N}^3", card)
    del captured_big
    combined_launches = run_combined(f"{MAIN_N}^3 ppc 1", cfg, state, DT, results, card,
                                     report=True)
    main_phi = state.phi
    del state
    torch.cuda.empty_cache()

    # Phase 4: the 32^3 card step vs the same step on the CPU.
    cpu_next = ft.step(cpu_state, DT, small)
    worst = 0.0
    for name in (*FIELDS, "k1"):
        d = float((getattr(card_next, name).cpu() - getattr(cpu_next, name)).abs().max())
        if d > 1e-4:
            raise AssertionError(f"phase 4: {name} differs by {d} > 1e-4")
        worst = max(worst, d)
        say(f"phase 4: {SMALL_N}^3 step, card vs CPU, {name}: max abs diff {d!r}")
    say(f"phase 4: all fields within 1e-4 (max {worst!r})")
    nan_phase(small, dev)

    # Phase 5: the demo entry point; phase 6: the physical configuration.
    demo_launches, demo_ms, demo_combined_launches, demo_phi = run_demo(table, results, card)
    phys_launches, phys_ms, phys_peak = run_physical(table, results, card)
    torch.cuda.empty_cache()
    apic = run_apic(table, results, card)
    torch.cuda.empty_cache()
    render = render_phase(dev, main_phi, step_ms, demo_phi, demo_ms, card)
    torch.cuda.empty_cache()
    two_d = two_d_phase(table, results, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    app = app_phase(card)
    say(f"phase P: {time.perf_counter() - t0:.1f} s")
    del main_phi, demo_phi
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    big = big_phase(table, results, card)
    say(f"phase B: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    multi = multi_phase(results, card)

    # Phase 8.
    symbol = {key: k["module"].KERNEL.symbol for key, k in table.items()}
    kernels = [
        {
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": (apic["launches"]["demo 64^3 ppc 2"] if key == "p2g_apic"
                         else demo_launches if key == "p2g2" else launches)[symbol[key]],
            "max_abs_err": results[key]["max_abs_err"],
            "ms": results[key]["ms"], "plain_ms": results[key]["plain_ms"],
            "bound_ms": results[key]["bound_ms"], "bound_by": results[key]["bound_by"],
            "library_ms": None,
        }
        for key, k in table.items()
    ]
    for key, name, symbol, source, replaces in (
        ("sweep_x", "sweep_x_carry", "fst_sweep_x_carry", "fluidsimulation_tpu_torch/csrc/sweep.cu",
         "fluidsimulation_tpu/ops/pallas_sweep.py:30"),
        ("sor_half", "sor_half", "fst_sor_half", "fluidsimulation_tpu_torch/csrc/sor.cu",
         "fluidsimulation_tpu/ops/pallas_sor.py:68"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": multi["M1"]["launches"][symbol],
            **{k: results[key][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by")},
            "library_ms": None,
        })
    kernels.append({
        "name": "pack_mac3_combined", "route": "cuda",
        "source": "fluidsimulation_tpu_torch/csrc/pack.cu",
        "replaces": "fluidsimulation_tpu/core/pallas_pack.py:32",
        **{key: results["pack"][key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    say(json.dumps({
        "kernels": kernels, "card": card,
        "step_ms": {"128^3 ppc 1": step_ms, "demo 64^3 ppc 2": demo_ms, "128^3 ppc 2": phys_ms},
        "launches": {"128^3 ppc 1": launches, "demo 64^3 ppc 2": demo_launches,
                     "128^3 ppc 2": phys_launches,
                     "combined 128^3 ppc 1": combined_launches,
                     "combined 64^3 ppc 2": demo_combined_launches},
        "peak_bytes_128^3_ppc2": phys_peak,
        "apic": apic,
        "render": render,
        "two_d": two_d,
        "app": app,
        "big": big,
        "multi": multi,
    }))
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
