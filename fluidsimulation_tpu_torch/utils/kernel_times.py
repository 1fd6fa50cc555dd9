"""Times of the hand kernels on the card, on the inputs the step hands them,
at the three configurations chip_smoke.py drives: 128^3 ppc 1 (20 steps,
dt 1/60), the demo's 64^3 ppc 2 (60 steps, dt 1/120) and 128^3 ppc 2 (10
steps, dt 1/120). The last step's arguments to each kernel wrapper are kept
and each kernel is timed on them by CUDA events: the 24 sweeps, the 8 sweeps
of each axis alone (in their SWEEP_ORDER order), the SOR solve, P2G, the FLIP
gather and the 27-neighbourhood pass, and the FLIP update as the step calls
it (``flip_ms``: the diff grids and the gather where the checkout forms them
in PyTorch). Back-to-back wrapper calls are bound by the host's launch cost
(about 0.03 ms) where the kernel is shorter, so the FLIP gather and the pass
are also timed alone under torch.profiler (``g2p_kernel_ms``,
``seed_kernel_ms``), and the FLIP update by its device time
(``flip_device_ms``: every kernel and copy it launches). P2G, the FLIP
gather and the pass launched twice on the same inputs must give equal
results (``*_deterministic``); ``walk_stats`` says how P2G's work lies over
the cells. The median step (CUDA events, a sync after each step, the first
two steps left out) comes with them. On the final grids of the first two
configurations the combined-key pack (``core/cuda_pack.py``, no step calls
it) is timed by events (``pack_ms``) and alone under torch.profiler
(``pack_kernel_ms``), beside a zero-fill of a table of the same bytes, the
card's store-rate ceiling (``pack_fill_ms``); two launches must give the
same bits (``pack_deterministic``).

Run on the card from the root of a checkout:

    python -m fluidsimulation_tpu_torch.utils.kernel_times [--dump DIR] [--against DIR]

It imports the ``fluidsimulation_tpu_torch`` of the working directory, so a
copy of this file at the root of an older checkout, run there as
``python kernel_times.py``, times that checkout's kernels. ``--dump DIR``
saves each configuration's inputs and outputs of P2G, the pass, the FLIP
update and the pack there; ``--against DIR`` runs this checkout's on inputs
saved so (by another checkout) and reports whether its outputs equal the
saved ones bit for bit (``p2g_equal_to_dump``, ``seed_equal_to_dump``,
``flip_equal_to_dump``, ``pack_equal_to_dump``; the pack's table through
int32 views, so NaN payloads and -0.0 count). The FLIP update is compared
through ``flip_update_carry(cfg, pos, vel, u, v, w, old_u, old_v, old_w,
alpha)``, whose inputs every checkout takes and whose outputs are its
gather's. Prints one JSON line per configuration, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

CONFIGS = (  # (label, grid, ppc, dt, steps)
    ("128^3 ppc 1", 128, 1, 1.0 / 60.0, 20),
    ("64^3 ppc 2", 64, 2, 1.0 / 120.0, 60),
    ("128^3 ppc 2", 128, 2, 1.0 / 120.0, 10),
)
PACK_CONFIGS = ("128^3 ppc 1", "64^3 ppc 2")  # the grids the pack is timed on
REPS = 20
SITES = (
    ("ops.levelset", "neighborhood_pass", "seed"),
    ("ops.levelset", "sweep_closest", "sweep"),
    ("ops.p2g", "p2g_accumulate", "p2g"),
    ("ops.project", "sor_pressure", "sor"),
    ("ops.flip", "g2p_flip", "g2p"),
    ("solver.step3d", "flip_update_carry", "flip"),
)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean ms of fn() over reps runs by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name: str, reps: int = REPS) -> float:
    """Mean ms a run of fn() spends in device kernels whose name holds
    ``name``, under torch.profiler (the kernel alone, without the host's
    launch gaps that cuda_ms sees when the kernel is shorter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key) / 1e3 / reps


def sweep_runner(cuda_sweep):
    """fn(cfg, phi, cpos, codes) running the sweeps of ``codes`` on the card."""
    if hasattr(cuda_sweep, "sweeps"):
        return cuda_sweep.sweeps
    # A checkout from before the one-call entry point: one fst_sweep launch
    # a sweep, the first reading the inputs, the rest in place.
    def sweeps(cfg, phi, cpos, codes):
        phi_out, cpos_out = torch.empty_like(phi), torch.empty_like(cpos)
        src = (phi.data_ptr(), cpos.data_ptr())
        for code in codes:
            axis, reverse = cuda_sweep.CODE[code]
            cuda_sweep.KERNEL.launch(phi.device, *src, phi_out.data_ptr(), cpos_out.data_ptr(),
                                     cfg.nx, cfg.ny, cfg.nz, axis, int(reverse),
                                     float(cfg.particle_radius))
            src = (phi_out.data_ptr(), cpos_out.data_ptr())
        return phi_out, cpos_out

    return sweeps


def flat(out):
    """A wrapper's outputs as a flat list of tensors (P2G's [(acc, amt)] *
    3 as six)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in flat(part)]


def same(a, b) -> bool:
    """Equal tensors, NaN where the other has NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def bits(a, b) -> bool:
    """Equal float32 tensors bit for bit (NaN payloads and -0.0 count)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def against_dump(fn, args, key: str, row, dump: Path | None, against: Path | None,
                 tag: str, equal=same) -> None:
    """Save fn's tensor arguments and outputs under ``dump``; or run fn on
    arguments saved under ``against`` and record whether its outputs equal
    the saved ones bit for bit. ``args`` is (cfg, *rest): tensors in rest
    are saved and moved, other values kept."""
    cfg, rest = args[0], args[1:]
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        torch.save({"args": [a.cpu() if isinstance(a, torch.Tensor) else a for a in rest],
                    "out": [t.cpu() for t in flat(fn(*args))]}, dump / f"{tag}.{key}.pt")
    if against is not None:
        saved = torch.load(against / f"{tag}.{key}.pt", weights_only=False)
        dev = args[1].device
        theirs = flat(fn(cfg, *(a.to(dev) if isinstance(a, torch.Tensor) else a
                                for a in saved["args"])))
        want = [t.to(dev) for t in saved["out"]]
        row[f"{key}_equal_to_dump"] = all(equal(a, b) for a, b in zip(theirs, want))
        row[f"{key}_max_abs_diff_to_dump"] = max(
            float((a - b).nan_to_num(0.0).abs().max()) for a, b in zip(theirs, want))
        del saved, theirs, want


def deterministic(fn, args, equal=same) -> bool:
    return all(equal(a, b) for a, b in zip(flat(fn(*args)), flat(fn(*args))))


def pack_times(cfg, state, row, dump: Path | None, against: Path | None, tag: str) -> None:
    """The combined-key pack on the state's grids: by events, alone under
    torch.profiler, the zero-fill of a table of the same bytes, two
    launches bit-equal, and ``--dump``/``--against``."""
    from fluidsimulation_tpu_torch.core import cuda_pack

    def pack(cfg, u, v, w):
        return cuda_pack.pack_mac3_combined(u, v, w)

    grids = (state.u, state.v, state.w)
    row["pack_ms"] = cuda_ms(lambda: pack(cfg, *grids))
    row["pack_kernel_ms"] = kernel_ms(lambda: pack(cfg, *grids), "pack_mac3_combined")
    table = torch.empty((cfg.nx * cfg.ny * (cfg.nz - 1), cuda_pack.ROW), device=state.u.device)
    row["pack_fill_ms"] = kernel_ms(table.zero_, "")
    del table
    row["pack_deterministic"] = deterministic(pack, (cfg, *grids), equal=bits)
    against_dump(pack, (cfg, *grids), "pack", row, dump, against, tag, equal=bits)


def walk_stats(cfg, start) -> dict:
    """How the P2G walk's work lies over the cells, from the CSR offsets:
    the most particles in one cell; the particles a thread walks (its 27
    cells), as a mean over the threads with any; and the share of the lanes'
    steps that are work where a warp (32 consecutive z of one column) walks
    each of its 9 columns' 3-cell runs as often as its busiest lane."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    counts = (start[1:] - start[:-1]).float().reshape(nx, ny, nz)
    pad = torch.nn.functional.pad(counts, (1, 1 + (-nz) % 32, 1, 1, 1, 1))
    zt = -(-nz // 32)
    walk = torch.zeros_like(counts)
    useful = steps = 0.0
    for dx in range(3):
        for dy in range(3):
            col = pad[dx:dx + nx, dy:dy + ny]
            run = col[:, :, 0:32 * zt] + col[:, :, 1:32 * zt + 1] + col[:, :, 2:32 * zt + 2]
            run[:, :, nz:] = 0  # lanes past the grid walk nothing
            walk += run[:, :, :nz]
            useful += float(run.sum())
            steps += float(run.reshape(nx, ny, zt, 32).amax(-1).sum())
    return {"cell_max_particles": int(counts.max()),
            "walk_mean_particles": float(walk[walk > 0].mean()),
            "walk_max_particles": int(walk.max()),
            "warp_step_efficiency": useful / (32 * steps)}


def main(argv=None) -> int:
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.ops import cuda_g2p, cuda_p2g, cuda_seed, cuda_sor, cuda_sweep, flip
    from fluidsimulation_tpu_torch.utils.profiling import hooked

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dump", type=Path, default=None)
    parser.add_argument("--against", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch.cuda.is_available() is false; this needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sweeps = sweep_runner(cuda_sweep)
    by_axis = {name: [c for c in cuda_sweep.SWEEP_ORDER if cuda_sweep.CODE[c][0] == axis]
               for axis, name in enumerate("xyz")}
    for label, n, ppc, dt, steps in CONFIGS:
        cfg = ft.SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n), particles_per_cell_axis=ppc)
        state = ft.init_state(cfg, "cuda:0")
        step_ms = []
        for _ in range(steps - 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state = ft.step(state, dt, cfg)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
        captured = {}

        def record(key, orig, args, _captured=captured):
            _captured[key] = args
            return orig(*args)

        with hooked(SITES, record):
            state = ft.step(state, dt, cfg)
        torch.cuda.synchronize()
        _, phi, cpos = captured["sweep"]
        row = {"config": label, "card": card, "source": ft.__file__,
               "step_ms": statistics.median(step_ms[2:]),
               "sweeps_ms": cuda_ms(lambda: cuda_sweep.sweep_closest(cfg, phi, cpos))}
        for name, codes in by_axis.items():
            row[f"sweeps_{name}_ms"] = cuda_ms(lambda c=codes: sweeps(cfg, phi, cpos, c))
        row["sor_ms"] = cuda_ms(lambda: cuda_sor.sor_pressure(*captured["sor"]))
        row["fluid_cells"] = int((captured["sor"][1] < 0).sum())
        row["g2p_ms"] = cuda_ms(lambda: cuda_g2p.g2p_flip(*captured["g2p"]))
        row["g2p_kernel_ms"] = kernel_ms(lambda: cuda_g2p.g2p_flip(*captured["g2p"]),
                                         "g2p_flip_kernel")
        row["flip_ms"] = cuda_ms(lambda: flip.flip_update_carry(*captured["flip"]))
        row["flip_device_ms"] = kernel_ms(lambda: flip.flip_update_carry(*captured["flip"]), "")
        row["seed_ms"] = cuda_ms(lambda: cuda_seed.neighborhood_pass(*captured["seed"]))
        row["seed_kernel_ms"] = kernel_ms(lambda: cuda_seed.neighborhood_pass(*captured["seed"]),
                                          "neighborhood_pass_kernel")
        row.update(walk_stats(cfg, captured["p2g"][3]))
        row["p2g_ms"] = cuda_ms(lambda: cuda_p2g.p2g_accumulate(*captured["p2g"]))
        tag = label.replace("^", "").replace(" ", "_")
        for key, fn, fn_args in (
            ("p2g", cuda_p2g.p2g_accumulate, captured["p2g"]),
            ("seed", cuda_seed.neighborhood_pass, captured["seed"]),
            ("g2p", cuda_g2p.g2p_flip, captured["g2p"]),
            ("flip", flip.flip_update_carry, captured["flip"][:10]),
        ):
            if key != "flip":
                row[f"{key}_deterministic"] = deterministic(fn, fn_args)
            if key != "g2p":
                against_dump(fn, fn_args, key, row, args.dump, args.against, tag)
        if label in PACK_CONFIGS:
            pack_times(cfg, state, row, args.dump, args.against, tag)
        print(json.dumps(row), flush=True)
        del state, captured, phi, cpos
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
