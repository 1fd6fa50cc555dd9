#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fluidsimulation_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the four hand-written CUDA kernels from csrc/, compares each with
its plain PyTorch version on the card, drives the port's 3D step on the
128^3 dam break (1,000,188 particles, dt = 1/60) through ``step``, checks
that every step went through the kernels, and compares a 32^3 step on the
card with the same step on the CPU. Any failure raises, and then the last
line is not printed. Without a CUDA card it exits non-zero at once.

Phases, each printing before the next:
  0  card name and power limit; TF32 off
  1  kernel build (seconds)
  2  kernels vs plain versions at 32^3 (here) and at 128^3 (after phase 3),
     on the inputs each kernel received in a step of the main path
  3  20 steps at 128^3; launch counts per step; median step time
  4  the 32^3 card step of phase 2 vs the same step on the CPU
  5  {"kernels": [...]} and then {"ok": true, "device": {...}}
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

DT = 1.0 / 60.0
N_STEPS = 20
N_WARMUP = 2
DEVICE = "cuda:0"
MAIN_N = 128  # grid cells per axis of the main path
MAIN_PARTICLES = 1_000_188
SMALL_N = 32


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


@contextlib.contextmanager
def capture(store: dict):
    """Record the arguments the step passes to each kernel wrapper."""
    from fluidsimulation_tpu_torch.ops import flip, levelset, p2g

    sites = [
        (levelset, "neighborhood_pass", "seed"),
        (levelset, "sweep_closest", "sweep"),
        (p2g, "p2g_accumulate", "p2g"),
        (flip, "g2p_flip", "g2p"),
    ]
    saved = []
    for module, attr, key in sites:
        orig = getattr(module, attr)

        def rec(*args, _orig=orig, _key=key):
            store[_key] = args
            return _orig(*args)

        saved.append((module, attr, orig))
        setattr(module, attr, rec)
    try:
        yield store
    finally:
        for module, attr, orig in saved:
            setattr(module, attr, orig)


def kernel_table():
    from fluidsimulation_tpu_torch.ops import cuda_g2p, cuda_p2g, cuda_seed, cuda_sweep

    return {
        "seed": dict(
            module=cuda_seed, wrapper=cuda_seed.neighborhood_pass,
            plain=cuda_seed.neighborhood_pass_plain,
            name="neighborhood_pass", source="fluidsimulation_tpu_torch/csrc/seed.cu",
            replaces="fluidsimulation_tpu/ops/pallas_seed.py:22", per_step=1,
        ),
        "sweep": dict(
            module=cuda_sweep, wrapper=cuda_sweep.sweep_closest,
            plain=cuda_sweep.sweep_closest_plain,
            name="sweep_closest", source="fluidsimulation_tpu_torch/csrc/sweep.cu",
            replaces="fluidsimulation_tpu/ops/pallas_sweep.py:30",
            per_step=len(cuda_sweep.SWEEP_ORDER),
        ),
        "p2g": dict(
            module=cuda_p2g, wrapper=cuda_p2g.p2g_accumulate,
            plain=lambda cfg, pcs, vels, start: cuda_p2g.p2g_accumulate_plain(cfg, pcs, vels),
            name="p2g_accumulate", source="fluidsimulation_tpu_torch/csrc/p2g.cu",
            replaces="fluidsimulation_tpu/ops/pallas_p2g_super.py:71", per_step=1,
        ),
        "g2p": dict(
            module=cuda_g2p, wrapper=cuda_g2p.g2p_flip, plain=cuda_g2p.g2p_flip_plain,
            name="g2p_flip", source="fluidsimulation_tpu_torch/csrc/g2p.cu",
            replaces="fluidsimulation_tpu/core/pallas_pairpack.py:52", per_step=1,
        ),
    }


def compare(key: str, got, want) -> tuple[float, str]:
    """Hold a kernel's outputs against its plain version's. Returns the
    largest absolute difference and a note; raises past the tolerance."""
    if key in ("seed", "sweep"):
        # Expected bit-exact (-fmad=false); the bound is the JAX package's
        # own Pallas-vs-XLA bound for these passes.
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        if err > 2e-6:
            raise AssertionError(f"{key}: max abs err {err} > 2e-6")
        return err, "bit-exact" if exact else "within 2e-6"
    if key == "p2g":
        # Summation order differs (gather vs index_add_): validity equal
        # except within rounding of the threshold; rtol = atol = 2e-4 on
        # faces valid in both.
        err, flips = 0.0, 0
        for (acc_k, amt_k), (acc_p, amt_p) in zip(got, want):
            vk, vp = amt_k > 0.01, amt_p > 0.01
            near = (amt_p - 0.01).abs() < 1e-6
            bad = (vk != vp) & ~near
            if bool(bad.any()):
                raise AssertionError(f"p2g: {int(bad.sum())} faces differ in validity")
            flips += int((vk != vp).sum())
            both = vk & vp
            gk = acc_k / amt_k.clamp(min=1e-30)
            gp = acc_p / amt_p.clamp(min=1e-30)
            d = (gk - gp).abs()[both]
            if d.numel() and bool((d > 2e-4 + 2e-4 * gp.abs()[both]).any()):
                raise AssertionError(f"p2g: normalised faces differ by up to {float(d.max())}")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        return err, f"validity equal ({flips} faces within 1e-6 of the threshold flip)"
    # g2p: vel' and k1 within 1e-5 abs.
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if err > 1e-5:
        raise AssertionError(f"g2p: max abs err {err} > 1e-5")
    return err, "within 1e-5"


def check_kernels(table, args_by_key, label: str, results: dict, timed: bool) -> None:
    for key, k in table.items():
        args = args_by_key[key]
        got = k["wrapper"](*args)
        want = k["plain"](*args)
        torch.cuda.synchronize()
        err, note = compare(key, got, want)
        entry = results.setdefault(key, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        line = f"phase 2 [{label}] {k['name']}: max_abs_err={err!r} ({note})"
        if timed:
            reps_plain = 2 if key == "sweep" else 10
            entry["ms"] = cuda_ms(lambda: k["wrapper"](*args), 20)
            entry["plain_ms"] = cuda_ms(lambda: k["plain"](*args), reps_plain)
            line += f"  kernel {entry['ms']!r} ms, plain {entry['plain_ms']!r} ms"
        say(line)


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
    check_kernels(table, captured_small, f"{SMALL_N}^3", results, timed=False)

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
    for k in table.values():
        k["module"].KERNEL.launches = 0
    times = []
    captured_big: dict = {}
    for i in range(N_STEPS):
        before = {key: k["module"].KERNEL.launches for key, k in table.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == N_STEPS - 1:
            with capture(captured_big):
                state = ft.step(state, DT, cfg)
        else:
            state = ft.step(state, DT, cfg)
        end.record()
        torch.cuda.synchronize()
        if i >= N_WARMUP:
            times.append(start.elapsed_time(end))
        for key, k in table.items():
            got = k["module"].KERNEL.launches - before[key]
            if got != k["per_step"]:
                raise AssertionError(f"step {i}: {k['name']} launched {got} times, expected {k['per_step']}")
    launches = {key: k["module"].KERNEL.launches for key, k in table.items()}
    say(f"phase 3: launches in {N_STEPS} steps: " + ", ".join(
        f"{table[key]['name']}={v}" for key, v in launches.items()))
    for name in ("pos", "vel", "u", "v", "w", "phi", "k1"):
        if not bool(getattr(state, name).isfinite().all()):
            raise AssertionError(f"phase 3: non-finite values in {name}")
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

    # Phase 2 at 128^3, on the inputs of the last main-path step.
    check_kernels(table, captured_big, f"{MAIN_N}^3", results, timed=True)

    # Phase 4: the 32^3 card step vs the same step on the CPU.
    cpu_next = ft.step(cpu_state, DT, small)
    worst = 0.0
    for name in ("pos", "vel", "u", "v", "w", "phi", "k1"):
        d = float((getattr(card_next, name).cpu() - getattr(cpu_next, name)).abs().max())
        if d > 1e-4:
            raise AssertionError(f"phase 4: {name} differs by {d} > 1e-4")
        worst = max(worst, d)
        say(f"phase 4: {SMALL_N}^3 step, card vs CPU, {name}: max abs diff {d!r}")
    say(f"phase 4: all fields within 1e-4 (max {worst!r})")

    # Phase 5.
    kernels = [
        {
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[key],
            "max_abs_err": results[key]["max_abs_err"],
            "ms": results[key]["ms"], "plain_ms": results[key]["plain_ms"],
        }
        for key, k in table.items()
    ]
    say(json.dumps({"kernels": kernels, "step_ms": step_ms, "card": card}))
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
