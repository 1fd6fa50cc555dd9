#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fluidsimulation_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the six hand-written CUDA kernels from csrc/, compares each with
its plain PyTorch version on the card, and drives three paths of the port,
each with the launch counts set to 0 just before it and read just after:

  * the 128^3 dam break (1,000,188 particles, ppc 1, dt = 1/60) through
    ``step``, 20 steps;
  * the demo entry point at its defaults, ``app.demo.main``: 64^3, ppc 2,
    953,312 particles, 60 steps at rate 0.5, saving its final state;
  * the physical configuration of bench.py: 128^3, ppc 2, 8,001,504
    particles, dt = 1/120, 10 steps.

Every step of every path must launch each kernel the expected number of
times (the 24 sweeps are one C call, one launch count); the combined-key
pack, which no step calls, 0 times. On the final
states of the first two paths it then drives the combined-key interpolation
(core/interp_combined.py): the pack kernel, the interpolation of every
particle through its table, and RK3 stages 2-3 through it. A 32^3 card step
is compared with the same step on the CPU. Any failure raises, and then the
last line is not printed. Without a CUDA card it exits non-zero at once.

Phases, each printing before the next:
  0  card name and power limit; TF32 off
  1  kernel build (seconds)
  2  kernels vs plain versions at 32^3 (here), at 128^3 (after phase 3),
     at 64^3/ppc 2 (after phase 5) and at 128^3/ppc 2 (after phase 6), on
     the inputs each kernel received in the last step of the path; P2G, the
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
  5  the demo at its defaults; launches per step; checkpoint reload
  6  10 steps of 128^3 / ppc 2; median step time, peak device memory
  7  combined-key interpolation, on the final state of phase 3 (128^3,
     after phase 3's kernel checks; its times reported) and of phase 5
     (64^3 ppc 2; times printed only): the pack's launch count, the pack vs
     its plain form bit for bit (int32 views) and a second launch bit-equal,
     the interpolation vs the pointwise one, RK3 vs advect_rk3_cached; the
     pack's device time under torch.profiler (the report's ms) and its time
     by events, beside a zero-fill of a table of the same bytes
  8  {"kernels": [...]} and then {"ok": true, "device": {...}}
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
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
FIELDS = ("pos", "vel", "u", "v", "w", "phi")

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
    set cuda_ms of a kernel shorter than about 0.03 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


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
        ("ops.flip", "g2p_flip", "g2p"),
    ], record)


def kernel_table():
    """One entry per line of the kernels report. ``site`` names the capture
    key whose arguments the entry's wrapper takes."""
    from fluidsimulation_tpu_torch.ops import cuda_g2p, cuda_p2g, cuda_seed, cuda_sor, cuda_sweep

    def p2g_plain(cfg, pcs, vels, start):
        return cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels)

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
    }


def per_step_launches() -> dict:
    """Kernel module -> launches in one step, on every path."""
    from fluidsimulation_tpu_torch.core import cuda_pack
    from fluidsimulation_tpu_torch.ops import cuda_g2p, cuda_p2g, cuda_seed, cuda_sor, cuda_sweep

    return {cuda_seed: 1, cuda_sweep: 1, cuda_p2g: 1, cuda_sor: 1, cuda_g2p: 1, cuda_pack: 0}


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
        and writes the (nx*ny*(nz-1), 64) table.
    """
    cfg = args[0]
    cells = cfg.nx * cfg.ny * cfg.nz
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
    elif key == "sor":
        fluid = int((args[1] < 0).sum())
        nbytes, ops = 4 * 4 * cells, 11 * fluid * cfg.sor_iterations
    elif key == "pack":
        nbytes, ops = 4 * faces + 4 * 64 * cfg.nx * cfg.ny * (cfg.nz - 1), 0
    else:
        raise KeyError(key)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def compare(key: str, got, want) -> tuple[float, str]:
    """Hold a kernel's outputs against its plain version's. Returns the
    largest absolute difference and a note; raises past the tolerance."""
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
        err, note = compare(key, got, want)
        if key in ("p2g", "p2g2", "seed", "g2p"):
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


def timed_steps(check, n_steps, state, dt, cfg, captured):
    """n_steps of ``step`` through the launch check, CUDA-event timed; the
    last step's kernel arguments go to ``captured``. Returns the state and
    the step times after the warm-up."""
    import fluidsimulation_tpu_torch as ft

    times = []
    for i in range(n_steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == n_steps - 1:
            with capture(captured):
                state = check.step(lambda: ft.step(state, dt, cfg))
        else:
            state = check.step(lambda: ft.step(state, dt, cfg))
        end.record()
        torch.cuda.synchronize()
        if i >= N_WARMUP:
            times.append(start.elapsed_time(end))
    return state, times


def check_finite(label: str, state) -> None:
    for name in (*FIELDS, "k1"):
        t = getattr(state, name)
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

    bad = 5
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


def run_demo(table, results, card):
    """Phase 5: app.demo.main at its defaults, every step through the
    launch check; then the kernels on the last step's inputs and phase 7
    on the final state."""
    from fluidsimulation_tpu_torch.app import demo
    from fluidsimulation_tpu_torch.utils.checkpoint import load_state
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    check = LaunchCheck("phase 5 (demo 64^3 ppc 2)")
    times, seen, verdicts, captured = [], {}, [], {}

    def counted_step(orig_step, state, dt, cfg):
        i = check.steps
        if i == 0:
            if state.pos.shape[0] != DEMO_PARTICLES:
                raise AssertionError(f"demo: expected {DEMO_PARTICLES} particles, "
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

    def around(label, orig, args):
        return (counted_step if label == "step" else recorded_check)(orig, *args)

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out_dir:
        with hooked([("app.demo", "step", "step"), ("app.demo", "check_state", "check")], around):
            rc = demo.main(["--device", "cuda", "--save-state", "--out", out_dir])
        if rc != 0:
            raise AssertionError(f"demo: main returned {rc}")
        launches = check.totals()
        if check.steps != DEMO_STEPS:
            raise AssertionError(f"demo: ran {check.steps} steps, expected {DEMO_STEPS}")
        if not verdicts or not all(verdicts):
            raise AssertionError(f"demo: check_state verdicts {verdicts}")
        state, cfg = seen["state"], seen["cfg"]
        check_finite("phase 5", state)
        y1 = float(state.pos[:, 1].mean())
        if not y1 < seen["y0"]:
            raise AssertionError(f"demo: centre of mass did not fall ({seen['y0']} -> {y1})")
        loaded = load_state(str(Path(out_dir) / "final_state.npz"), state.pos.device, cfg)
        for name in FIELDS:
            if not torch.equal(getattr(loaded, name), getattr(state, name)):
                raise AssertionError(f"demo: checkpoint field {name} differs from the final state")
    step_ms = statistics.median(times[N_WARMUP:])
    say(f"phase 5: {check.steps} steps of {cfg.nx}^3, {DEMO_PARTICLES} particles; all fields "
        f"finite; mean y {seen['y0']!r} -> {y1!r}; checkpoint reloads equal; "
        f"{len(verdicts)} check_state verdicts all true")
    say(f"phase 5: median step {step_ms!r} ms over {len(times) - N_WARMUP} steps after "
        f"{N_WARMUP} warm-up (min {min(times[N_WARMUP:])!r}, max {max(times[N_WARMUP:])!r}) "
        f"on {card}")
    check_kernels(table, ("seed", "sweep", "p2g2", "sor", "g2p"), captured,
                  f"{cfg.nx}^3 ppc 2", results, timed=("seed", "sweep", "p2g2", "sor", "g2p"),
                  reported=("p2g2",))
    sweep_sor_details(captured, f"{cfg.nx}^3 ppc 2", card)
    combined_launches = run_combined(f"{cfg.nx}^3 ppc 2", cfg, state, seen["dt"], results,
                                     card, report=False)
    return launches, step_ms, combined_launches


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
    demo_launches, demo_ms, demo_combined_launches = run_demo(table, results, card)
    phys_launches, phys_ms, phys_peak = run_physical(table, results, card)

    # Phase 8.
    symbol = {key: k["module"].KERNEL.symbol for key, k in table.items()}
    kernels = [
        {
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": (demo_launches if key == "p2g2" else launches)[symbol[key]],
            "max_abs_err": results[key]["max_abs_err"],
            "ms": results[key]["ms"], "plain_ms": results[key]["plain_ms"],
            "bound_ms": results[key]["bound_ms"], "bound_by": results[key]["bound_by"],
            "library_ms": None,
        }
        for key, k in table.items()
    ]
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
    }))
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
