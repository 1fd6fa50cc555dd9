"""Times of the level-set sweeps and the SOR on the card, on the inputs the
step hands them, at the three configurations chip_smoke.py drives: 128^3
ppc 1 (20 steps, dt 1/60), the demo's 64^3 ppc 2 (60 steps, dt 1/120) and
128^3 ppc 2 (10 steps, dt 1/120). The last step's arguments to
``sweep_closest`` and ``sor_pressure`` are kept and each kernel is timed on
them by CUDA events: the 24 sweeps, the 8 sweeps of each axis alone (in
their SWEEP_ORDER order) and the SOR solve. The median step (CUDA events,
a sync after each step, the first two steps left out) comes with them.

Run on the card from the root of a checkout:

    python -m fluidsimulation_tpu_torch.utils.kernel_times

It imports the ``fluidsimulation_tpu_torch`` of the working directory, so a
copy of this file at the root of an older checkout, run there as
``python kernel_times.py``, times that checkout's kernels: that is how the
one-launch-a-sweep kernel (``fst_sweep``) is timed beside the current one.
Prints one JSON line per configuration, with the card's name and power
limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

CONFIGS = (  # (label, grid, ppc, dt, steps)
    ("128^3 ppc 1", 128, 1, 1.0 / 60.0, 20),
    ("64^3 ppc 2", 64, 2, 1.0 / 120.0, 60),
    ("128^3 ppc 2", 128, 2, 1.0 / 120.0, 10),
)
REPS = 20


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


def main() -> int:
    import fluidsimulation_tpu_torch as ft
    from fluidsimulation_tpu_torch.ops import cuda_sor, cuda_sweep
    from fluidsimulation_tpu_torch.utils.profiling import hooked

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

        with hooked([("ops.levelset", "sweep_closest", "sweep"),
                     ("ops.project", "sor_pressure", "sor")], record):
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
        print(json.dumps(row), flush=True)
        del state, captured, phi, cpos
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
