"""CLI demo: the dam break of FluidSimDemo (FluidSimDemo.cpp) with its
raytraced frames. Port of fluidsimulation_tpu/app/demo.py, its 3D loop and
its 2D loop (--two-d), PIC/FLIP and APIC.

Runs the simulation and the renderer on the card by default (``--device
cuda``); pass ``--device cpu`` to run the plain PyTorch versions of the
kernels on the CPU. Without a card and without ``--device cpu`` it raises.
The reference's interactive controls (FluidSimDemo.cpp:7-13) come as one
command per line on stdin, read when stdin is a terminal or when
FST_DEMO_STDIN is set, and, with --serve PORT, from the live view's page
(app/liveview.py: http://127.0.0.1:PORT/ streams the frames and posts
drags, wheel turns and keys as these commands):

  +     double simulation speed  (GPFluidSim::IncreaseSpeed, clamp <= 1)
  -     halve simulation speed   (GPFluidSim::DecreaseSpeed)
  0     reset the camera view
  r     reset the simulation
  o X Y orbit the camera by (X, Y) "pixels" (mouse-drag equivalent)
  z DY  zoom (right-drag equivalent)
  q     quit

Each step handles the line stdin holds and then the live view's queue, in
that order, every command of them, and quits on 'q' only after them. A
malformed command is ignored. With --render-every K, every K-th step
renders a frame of the level set (render/raytrace.py::render_frame) to
OUT/frame_NNNNN.ppm, a binary PPM, and publishes it to the live view.
Every 10 steps it prints the step time and the Meter summary and checks
the state; an anomaly resets the simulation, as 'r' does. --profile runs
each step through utils/profiling.py::profile_step (profile_step_apic),
with the frame's render timed as DRAW, and prints the reference's table of
23 marks and the step time every step. With --save-state the final state goes to
OUT/final_state.npz in the JAX package's checkpoint format. --transfer apic
steps the APIC family (solver/apic.py) in place of PIC/FLIP, and saves an
APIC checkpoint.

--two-d runs the 2D solver (solver/step2d.py; with --transfer apic
solver/apic2d.py) on a --grid x --grid grid, as the archival 2D demo
FluidSimDemoOld.cpp does: the dam break with curl-noise initial velocities,
dt = clip(--dt x --rate, 0, max_dt), frames of particle splats over a
checkerboard (render/debug.py) to OUT/frame2d_NNNNN.ppm every
--render-every steps, each published to the live view. As the JAX
package's 2D loop, it reads no stdin, takes + - r q from the live view
(the other commands do nothing), checks no state, saves no state and
ignores --profile.

Usage:
  python -m fluidsimulation_tpu_torch --grid 64 --steps 120 \
      --render-every 2 --width 800 --height 600 --out out/
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np
import torch

from ..core.config import SimConfig, SimConfig2D
from ..core.state import init_apic_state2d, init_state, init_state2d
from ..render.camera import OrbitCamera
from ..render.debug import splat_particles_2d
from ..render.raytrace import render_frame
from ..solver.apic import init_apic_state, step_apic
from ..solver.apic2d import step_apic2d
from ..solver.step2d import step2d
from ..solver.step3d import clamp_dt, step
from ..utils.checkpoint import save_apic_state, save_state
from ..utils.metrics import Meter, check_state
from ..utils.profiling import profile_step, profile_step_apic
from .liveview import LiveView


def write_ppm(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0, inf) -> 8-bit binary PPM."""
    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())


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
    ap.add_argument("--grid", type=int, default=64, help="grid cells per axis (demo: 64; 2D too)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dt", type=float, default=1.0 / 60.0, help="frame dt before rate clamp")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="initial simulation rate (Simulation.h:84)")
    ap.add_argument("--ppc", type=int, default=2, help="particles per cell axis")
    ap.add_argument("--out", type=str, default="out")
    ap.add_argument("--save-state", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (default cuda; cpu runs the plain versions)")
    ap.add_argument("--render-every", type=int, default=0,
                    help="render every k steps (0 = never)")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--render-scale", type=int, default=1,
                    help="raytrace at 1/k resolution and nearest-upscale (k=1: the exact image)")
    ap.add_argument("--bounces", type=int, default=2, choices=(0, 1, 2),
                    help="water-bounce depth: 2 = the reference's traceWater2; 1/0 its lower tiers")
    ap.add_argument("--sphere-trace", action=argparse.BooleanOptionalAction, default=True,
                    help="sphere-trace skip of the inside water march (deepened texture, "
                    "render/interior.py); --no-sphere-trace runs the plain 1-cell march")
    ap.add_argument("--overstep", type=float, default=0.0,
                    help="omega > 1: enhanced sphere tracing of the outside water march; "
                    "0 or 1 = the exact reference march")
    ap.add_argument("--temporal", action=argparse.BooleanOptionalAction, default=False,
                    help="seed each frame's water marches from the previous frame's hit ts "
                    "while the camera stays still; cleared on camera moves and resets")
    ap.add_argument("--transfer", choices=("flip", "apic"), default="flip",
                    help="transfer model: the reference's hybrid PIC/FLIP (default) or the "
                    "APIC extension (affine particle-in-cell, quadratic B-splines; "
                    "solver/apic.py; not in the reference)")
    ap.add_argument("--two-d", action="store_true",
                    help="run the 2D solver (FluidSim / FluidSimDemoOld equivalent), rendering "
                    "particle splats over a checkerboard")
    ap.add_argument("--profile", action="store_true",
                    help="print the reference's per-stage table (23 marks) every step; 3D only")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="live view: stream the frames at http://127.0.0.1:PORT/ and take its "
                    "mouse orbit and zoom and its + - 0 r q keys as commands")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch.cuda.is_available() is false; pass --device cpu "
            "to run on the CPU"
        )
    if args.two_d:
        return _main_2d(args, dev)
    cfg = SimConfig(
        nx=args.grid, ny=args.grid, nz=args.grid,
        cells_per_meter=float(args.grid),
        particles_per_cell_axis=args.ppc,
    )
    os.makedirs(args.out, exist_ok=True)
    print(f"grid {cfg.nx}^3, {cfg.num_particles} particles on {dev}")
    if args.transfer == "apic":
        _init, _step, _save = init_apic_state, step_apic, save_apic_state
        _profile = profile_step_apic
    else:
        _init, _step, _save, _profile = init_state, step, save_state, profile_step
    state = _init(cfg, dev)
    cam = OrbitCamera()
    rate = args.rate
    meter = Meter(cfg.num_particles)
    # Temporal seed: the previous frame's march ts and the camera and
    # frame they are valid for (cleared on camera moves and resets).
    seed = {"t": None, "sig": None}
    live = _serve(args)
    try:
        for i in range(args.steps):
            cmds = [c for c in [_poll_stdin()] if c]
            if live is not None:
                cmds.extend(live.poll_cmds())
            quit_now = False
            for cmd in cmds:
                try:
                    if cmd in ("+", "-"):
                        rate = _rate_after(cmd, rate)
                    elif cmd == "0":
                        cam.reset()
                    elif cmd == "r":
                        state = _init(cfg, dev)
                        seed["t"] = None  # the water jumps discontinuously
                    elif cmd == "q":
                        quit_now = True
                    elif cmd.startswith("o "):
                        _, dx, dy = cmd.split()
                        cam.orbit(float(dx), float(dy))
                    elif cmd.startswith("z "):
                        cam.zoom(float(cmd.split()[1]), args.height)
                    else:
                        print(f"ignoring unknown command: {cmd!r}")
                except (ValueError, IndexError):
                    print(f"ignoring malformed command: {cmd!r}")
            if quit_now:
                break

            dt = clamp_dt(cfg, args.dt, rate)
            frames = []

            def draw(s):
                frames.append(_draw(args, cam, s.phi, seed))

            render = bool(args.render_every) and i % args.render_every == 0
            t0 = time.perf_counter()
            if args.profile:
                state, prof = _profile(state, dt, cfg, render_fn=draw if render else None)
            else:
                state = _step(state, dt, cfg)
                if render:
                    draw(state)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            meter.tick()
            step_ms = 1000 * (time.perf_counter() - t0)
            if args.profile:
                print(prof.table())
            if frames:
                write_ppm(os.path.join(args.out, f"frame_{i:05d}.ppm"), frames[0])
                if live is not None:
                    live.publish(frames[0])

            if i % 10 == 0 or args.profile:
                print(f"step {i}: {step_ms:.1f} ms  ({meter.summary()})")
            if i % 10 == 0 and not check_state(state):
                print("anomaly detected; resetting (reference 'r' behavior)")
                state = _init(cfg, dev)
    finally:
        if live is not None:
            live.close()

    if args.save_state:
        _save(os.path.join(args.out, "final_state.npz"), state, cfg)
    print(meter.summary())
    return 0


def _rate_after(cmd: str, rate: float) -> float:
    """The simulation rate after '+' (doubled, at most 1:
    GPFluidSim::IncreaseSpeed) or '-' (halved, at least the smallest
    float32 denormal: DecreaseSpeed, Simulation.cpp:304-312)."""
    if cmd == "+":
        return min(rate * 2.0, 1.0)
    return max(rate / 2.0, float(np.finfo(np.float32).smallest_subnormal))


def _serve(args) -> LiveView | None:
    """The live view on --serve's port, or None without --serve."""
    if not args.serve:
        return None
    live = LiveView(args.serve)
    print(f"live view: http://127.0.0.1:{live.port}/")
    return live


def _main_2d(args, dev) -> int:
    """The 2D loop (fluidsimulation_tpu/app/demo.py::_main_2d)."""
    cfg = SimConfig2D(nx=args.grid, ny=args.grid, cells_per_meter=float(args.grid))
    os.makedirs(args.out, exist_ok=True)
    print(f"2D grid {cfg.nx}x{cfg.ny}, {cfg.num_particles} particles on {dev}")
    if args.transfer == "apic":
        init, step_fn = init_apic_state2d, step_apic2d
    else:
        init, step_fn = init_state2d, step2d
    state = init(cfg, dev)
    rate = args.rate
    meter = Meter(cfg.num_particles)
    live = _serve(args)
    try:
        for i in range(args.steps):
            quit_now = False
            for cmd in live.poll_cmds() if live is not None else ():
                if cmd in ("+", "-"):
                    rate = _rate_after(cmd, rate)
                elif cmd == "r":
                    state = init(cfg, dev)
                elif cmd == "q":
                    quit_now = True
            if quit_now:
                break
            dt = float(np.clip(args.dt * rate, 0.0, cfg.max_dt))
            t0 = time.perf_counter()
            state = step_fn(state, dt, cfg)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            meter.tick()
            if args.render_every and i % args.render_every == 0:
                img = splat_particles_2d(state.pos, args.width, args.height).cpu().numpy()
                write_ppm(os.path.join(args.out, f"frame2d_{i:05d}.ppm"), img)
                if live is not None:
                    live.publish(img)
            if i % 10 == 0:
                print(f"step {i}: {1000 * (time.perf_counter() - t0):.1f} ms ({meter.summary()})")
    finally:
        if live is not None:
            live.close()
    print(meter.summary())
    return 0


def _draw(args, cam, phi, seed) -> np.ndarray:
    """One frame (FluidSimDemo::DrawScene) as an (height, width, 3) array.
    --render-scale k > 1 traces at 1/k of the size, rounded up, and
    nearest-upscales, cropped to the size asked for."""
    k = max(1, args.render_scale)
    w, h = -(-args.width // k), -(-args.height // k)
    co, right, up, fwd = cam.frame(w, h)
    temporal = args.temporal and args.bounces >= 1
    sig = (cam.cam_phi, cam.cam_theta, cam.fov, cam.radius, w, h, args.bounces)
    t_in = seed["t"] if (temporal and seed["sig"] == sig) else None
    # The JAX demo's tile heights: 100 rows at 128^3 and up, else 64.
    out = render_frame(phi, co, right, up, fwd, width=w, height=h,
                       band_rows=100 if max(phi.shape) >= 128 else 64,
                       bounces=args.bounces, sphere_trace=args.sphere_trace,
                       overstep=args.overstep, t_seed=t_in, return_t=temporal)
    if temporal:
        out, seed["t"] = out
        seed["sig"] = sig
    img = out.cpu().numpy()
    if k > 1:
        img = np.repeat(np.repeat(img, k, axis=0), k, axis=1)[: args.height, : args.width]
    return img


if __name__ == "__main__":
    sys.exit(main())
