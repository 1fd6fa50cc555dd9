"""CLI demo: the dam break of FluidSimDemo (FluidSimDemo.cpp), without
rendering. Port of the 3D FLIP loop of fluidsimulation_tpu/app/demo.py.

Runs the simulation on the card by default (``--device cuda``); pass
``--device cpu`` to run the plain PyTorch versions of the kernels on the
CPU. Without a card and without ``--device cpu`` it raises. The
reference's interactive controls (FluidSimDemo.cpp:7-13) come as one
command per line on stdin, read when stdin is a terminal or when
FST_DEMO_STDIN is set:

  +     double simulation speed  (GPFluidSim::IncreaseSpeed, clamp <= 1)
  -     halve simulation speed   (GPFluidSim::DecreaseSpeed)
  r     reset the simulation
  q     quit

Every 10 steps it prints the step time and the Meter summary and checks
the state; an anomaly resets the simulation, as 'r' does. With
--save-state the final state goes to OUT/final_state.npz in the JAX
package's checkpoint format.

Usage:
  python -m fluidsimulation_tpu_torch --grid 64 --steps 60 --out out/
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np
import torch

from ..core.config import SimConfig
from ..core.state import init_state
from ..solver.step3d import clamp_dt, step
from ..utils.checkpoint import save_state
from ..utils.metrics import Meter, check_state


def _poll_stdin() -> str | None:
    if sys.stdin is None or (not sys.stdin.isatty() and not os.environ.get("FST_DEMO_STDIN")):
        return None
    r, _, _ = select.select([sys.stdin], [], [], 0)
    if r:
        return sys.stdin.readline().strip()
    return None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m fluidsimulation_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", type=int, default=64, help="cubic grid size (demo: 64)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dt", type=float, default=1.0 / 60.0, help="frame dt before rate clamp")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="initial simulation rate (Simulation.h:84)")
    ap.add_argument("--ppc", type=int, default=2, help="particles per cell axis")
    ap.add_argument("--out", type=str, default="out")
    ap.add_argument("--save-state", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default cuda; cpu runs the plain versions)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch.cuda.is_available() is false; pass --device cpu "
            "to run on the CPU"
        )
    cfg = SimConfig(
        nx=args.grid, ny=args.grid, nz=args.grid,
        cells_per_meter=float(args.grid),
        particles_per_cell_axis=args.ppc,
    )
    os.makedirs(args.out, exist_ok=True)
    print(f"grid {cfg.nx}^3, {cfg.num_particles} particles on {dev}")
    state = init_state(cfg, dev)
    rate = args.rate
    meter = Meter(cfg.num_particles)

    for i in range(args.steps):
        cmd = _poll_stdin()
        if cmd == "+":
            rate = min(rate * 2.0, 1.0)
        elif cmd == "-":
            # Clamp at the smallest denormal like DecreaseSpeed
            # (Simulation.cpp:304-312).
            rate = max(rate / 2.0, float(np.finfo(np.float32).smallest_subnormal))
        elif cmd == "r":
            state = init_state(cfg, dev)
        elif cmd == "q":
            break
        elif cmd:
            print(f"ignoring unknown command: {cmd!r}")

        dt = clamp_dt(cfg, args.dt, rate)
        t0 = time.perf_counter()
        state = step(state, dt, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        meter.tick()
        step_ms = 1000 * (time.perf_counter() - t0)

        if i % 10 == 0:
            print(f"step {i}: {step_ms:.1f} ms  ({meter.summary()})")
            if not check_state(state):
                print("anomaly detected; resetting (reference 'r' behavior)")
                state = init_state(cfg, dev)

    if args.save_state:
        save_state(os.path.join(args.out, "final_state.npz"), state, cfg)
    print(meter.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
