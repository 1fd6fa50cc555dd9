"""python -m fluidsimulation_tpu_torch.parallel: the five multi-rank paths.

    python -m fluidsimulation_tpu_torch.parallel --ranks 4 --device cpu --backend gloo --grid 32

The counterpart of the JAX package's ``dryrun_multichip``: spawns a world
of ``--ranks`` ranks and runs, from the dam break at ``--grid``^3, the halo
step (parallel/halo_step.py), the step in the GSPMD layout
(parallel/sharding.py), the tile-sharded frame (render/sharded.py), the
APIC halo step (parallel/halo_apic.py) and the halo SOR (parallel/halo.py).
Each is held against its one-device counterpart run in this process on the
same device (the steps at pos 1e-6 and the rest 1e-4 after 2 steps, the
frame bit for bit, the SOR at 1e-5) and prints one ``ok`` line. Any failure
raises, and the exit code is not 0. Without ``--device cpu`` the ranks run
on the card (``--backend nccl``, the default, needs a card a rank; gloo
shares one).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import _build
from ..core.config import SimConfig
from ..ops.project import compute_diag, compute_rhs
from ..ops.cuda_sor import sor_pressure
from ..render.camera import OrbitCamera
from ..render.raytrace import render
from ..solver.apic import step_apic
from ..solver.step3d import step
from . import comm, runs

DT = 0.01
STEPS = 2
BOUNDS = {"pos": 1e-6}  # every other field: 1e-4 (tests/test_parallel.py:69-74)


def reference(family: str, cfg: SimConfig, device, n_steps: int):
    """The one-device steps from the same dam break."""
    state = runs.whole_state(family, cfg, device)
    fn = step_apic if family == "apic" else step
    for _ in range(n_steps):
        state = fn(state, DT, cfg)
    return state


def held(label: str, got: dict, want) -> str:
    diffs = []
    for name, arr in got.items():
        d = float(np.abs(arr - getattr(want, name).cpu().numpy()).max())
        if not d <= BOUNDS.get(name, 1e-4):
            raise AssertionError(f"{label}: {name} differs from the one-device step by {d}")
        diffs.append(f"{name} {d:.3g}")
    return ", ".join(diffs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fluidsimulation_tpu_torch.parallel")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="nccl", choices=comm.BACKENDS)
    ap.add_argument("--grid", type=int, default=32)
    args = ap.parse_args(argv)
    d, n = args.ranks, args.grid
    tag = f"parallel({d} ranks, {args.backend}, {args.device})"
    cfg = SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n))
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    if args.device == "cuda":
        _build.build()  # once, before the ranks start
    torch.set_num_threads(1)

    with comm.Ranks(d, args.backend, args.device) as ranks:
        for family, layout, what in (("flip", "x", "halo-exchange step"),
                                     ("flip", "gspmd", "GSPMD-layout step")):
            res = ranks.run(runs.halo_run, family, cfg, STEPS, DT, layout)
            diffs = held(what, res[0]["state"], reference(family, cfg, dev, STEPS))
            dropped = max(max(r["dropped"]) for r in res)
            if dropped:
                raise AssertionError(f"{what}: {dropped} particles dropped")
            print(f"{tag}: {what} ok, grid {n}^3, {cfg.num_particles} particles, {STEPS} steps, "
                  f"max |diff| vs the one-device step: {diffs}", flush=True)

        phi = reference("flip", cfg, dev, 1).phi
        w, h = 64, 48
        cam = OrbitCamera().frame(w, h)
        img = ranks.run(runs.render_run, phi.cpu().numpy(), cam, w, h, 24, 32)[0]["image"]
        want = render(phi, *cam, w, h, band_rows=24, band_cols=32).cpu().numpy()
        if not np.array_equal(img, want):
            raise AssertionError("sharded render: not the tiled frame bit for bit")
        print(f"{tag}: sharded render ok, {w}x{h} in 24x32 tiles, bit for bit the tiled frame",
              flush=True)

        res = ranks.run(runs.halo_run, "apic", cfg, STEPS, DT)
        diffs = held("APIC halo step", res[0]["state"], reference("apic", cfg, dev, STEPS))
        print(f"{tag}: APIC halo step ok, {STEPS} steps, max |diff| vs step_apic: {diffs}",
              flush=True)

        state = reference("flip", cfg, dev, 1)
        diag = compute_diag(cfg, state.phi)
        b = compute_rhs(cfg, state.u, state.v, state.w, DT)
        want = sor_pressure(cfg, state.phi, diag, b).cpu().numpy()
        p = ranks.run(runs.sor_run, cfg, *(t.cpu().numpy() for t in (state.phi, diag, b)))[0]["p"]
        err = float(np.abs(p - want).max())
        if not err <= 1e-5:
            raise AssertionError(f"halo SOR: differs from sor_pressure by {err}")
        print(f"{tag}: halo-SOR ok, max |diff| vs sor_pressure {err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
