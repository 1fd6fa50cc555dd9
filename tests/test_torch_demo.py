"""The port's demo CLI, checkpoints and metrics against the JAX package's.

``main`` runs at 16^3 on the CPU. Its checkpoint loads in the JAX package
and a JAX checkpoint loads in the port, bit for bit; Meter and check_state
give the JAX answers on the same states. With --render-every it writes the
frames JAX's write_ppm writes of the same arrays, and the camera commands
move the camera as JAX's OrbitCamera moves. Its 2D loop (--two-d) runs at
16^2 and writes the bytes JAX's write_ppm writes of JAX's splat of the same
state; the debug renderers (render/debug.py) give JAX's images. The saved
states (FLIP and APIC) and the 2D frames are held on the card too (marked
``cuda``), against the same steps on the card."""

import contextlib
import logging
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsimulation_tpu.app.demo import write_ppm as jax_write_ppm
from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.core.state import init_state as jax_init
from fluidsimulation_tpu.render import debug as jax_debug
from fluidsimulation_tpu.render.camera import OrbitCamera as JaxCamera
from fluidsimulation_tpu.solver.step3d import step_jit
from fluidsimulation_tpu.utils import checkpoint as jax_cp
from fluidsimulation_tpu.utils import metrics as jax_metrics

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.app.demo import main
from fluidsimulation_tpu_torch.render import debug
from fluidsimulation_tpu_torch.solver.step3d import clamp_dt
from fluidsimulation_tpu_torch.utils import checkpoint, metrics
from fluidsimulation_tpu_torch.utils.profiling import hooked

ROOT = Path(__file__).resolve().parent.parent
N = 16
KW = dict(nx=N, ny=N, nz=N, cells_per_meter=float(N))
CFG, JCFG = ft.SimConfig(**KW), JaxConfig(**KW)
FIELDS = ("pos", "vel", "u", "v", "w", "phi")


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """The demo's --device: cpu, and the card (marked cuda)."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def test_demo_runs_and_saves_what_it_stepped(tmp_path, capsys, device):
    """Three demo steps at 16^3 (ppc 2, rate 0.5) save the state that three
    calls of ``step`` at the clamped dt give on the same device, and JAX's
    load_state reads it with its config check."""
    out = tmp_path / "out"
    assert main(["--grid", str(N), "--steps", "3", "--device", device, "--save-state",
                 "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert f"grid {N}^3, {CFG.num_particles} particles on {device}" in text
    assert "step 0:" in text and "3 steps in" in text

    path = str(out / "final_state.npz")
    s = ft.init_state(CFG, device)
    for _ in range(3):
        s = ft.step(s, clamp_dt(CFG, 1.0 / 60.0, 0.5), CFG)
    loaded = jax_cp.load_state(path, JCFG)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)),
                                      getattr(s, name).cpu().numpy(), err_msg=name)
    with pytest.raises(ValueError, match="cfg"):
        jax_cp.load_state(path, JaxConfig(nx=8, ny=8, nz=8, cells_per_meter=8.0))


def test_demo_apic_runs_and_saves_what_it_stepped(tmp_path, capsys, device):
    """--transfer apic, two steps at 12^3 (ppc 2, rate 0.5): the saved APIC
    checkpoint is what two calls of ``step_apic`` at the clamped dt give on
    the same device, and JAX's load_apic_state reads it with its config
    check."""
    n = 12
    cfg = ft.SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n))
    out = tmp_path / "out"
    assert main(["--grid", str(n), "--transfer", "apic", "--device", device, "--steps", "2",
                 "--save-state", "--out", str(out)]) == 0
    assert "2 steps in" in capsys.readouterr().out
    s = ft.init_apic_state(cfg, device)
    for _ in range(2):
        s = ft.step_apic(s, clamp_dt(cfg, 1.0 / 60.0, 0.5), cfg)
    path = str(out / "final_state.npz")
    loaded = jax_cp.load_apic_state(path, JaxConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n)))
    for name in ("pos", "vel", "C", "u", "v", "w", "phi"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded, name)),
                                      getattr(s, name).cpu().numpy(), err_msg=name)
    with pytest.raises(ValueError, match="cfg"):
        jax_cp.load_apic_state(path, JCFG)


def test_jax_checkpoint_loads_in_port_bit_exact(tmp_path):
    j = step_jit(jax_init(JCFG), 0.01, JCFG, fast=False)
    path = str(tmp_path / "jax.npz")
    jax_cp.save_state(path, j, JCFG)
    s = checkpoint.load_state(path, "cpu", CFG)
    assert s.k1 is None
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(s, name).numpy(), np.asarray(getattr(j, name)))
    # Round trip through the port's writer, with and without the config row.
    for cfg in (CFG, None):
        again = str(tmp_path / f"port_{cfg is None}.npz")
        checkpoint.save_state(again, s, cfg)
        back = checkpoint.load_state(again, "cpu", CFG)
        for name in FIELDS:
            torch.testing.assert_close(getattr(back, name), getattr(s, name), rtol=0, atol=0)
    with pytest.raises(ValueError, match="cfg"):
        checkpoint.load_state(path, "cpu", ft.SimConfig(nx=8, ny=8, nz=8, cells_per_meter=8.0))


@pytest.mark.parametrize("shape", [(5, 4, 3), (6, 5), (1, 1, 1)], ids=["3d", "2d", "one"])
def test_tsv_export_is_jax_bytes_and_round_trips(tmp_path, shape):
    """export_array_tsv writes JAX's bytes for the same float32 array, from
    a tensor or an array (values of every magnitude, -0.0, inf and NaN);
    import_array_tsv reads them back bit for bit as a float32 tensor on the
    device asked for, and reads JAX's file the same."""
    rng = np.random.default_rng(5)
    arr = (rng.standard_normal(shape) * 10.0 ** rng.integers(-8, 8, shape)).astype(np.float32)
    flat = arr.reshape(-1)
    flat[:3] = [-0.0, np.inf, np.nan][: flat.size]
    jax_path, port_path = str(tmp_path / "jax.tsv"), str(tmp_path / "port.tsv")
    jax_cp.export_array_tsv(jax_path, arr)
    for given in (torch.from_numpy(arr), arr):
        checkpoint.export_array_tsv(port_path, given)
        assert Path(port_path).read_bytes() == Path(jax_path).read_bytes()
    for path in (port_path, jax_path):
        back = checkpoint.import_array_tsv(path, shape, "cpu")
        assert back.dtype == torch.float32 and back.device.type == "cpu"
        assert tuple(back.shape) == shape
        np.testing.assert_array_equal(back.numpy().view(np.int32), arr.view(np.int32))
        np.testing.assert_array_equal(back.numpy(), jax_cp.import_array_tsv(path, shape))


def test_tsv_particles_and_l2_match_jax(tmp_path):
    """export_particles_tsv writes JAX's bytes for a state's particles;
    l2_norm_diff sums in float64 and is JAX's within 1e-12 relative, on
    tensors and arrays; 0 for a grid and its TSV round trip."""
    s = ft.step(ft.init_state(CFG, "cpu"), 0.01, CFG)
    jax_cp.export_particles_tsv(str(tmp_path / "jax.tsv"), s.pos.numpy(), s.vel.numpy())
    checkpoint.export_particles_tsv(str(tmp_path / "port.tsv"), s.pos, s.vel)
    data = (tmp_path / "port.tsv").read_bytes()
    assert data == (tmp_path / "jax.tsv").read_bytes()
    assert data.count(b"\n") == CFG.num_particles
    a, b = s.u, ft.init_state(CFG, "cpu").u
    want = jax_cp.l2_norm_diff(a.numpy(), b.numpy())
    for x, y in ((a, b), (a.numpy(), b.numpy())):
        got = checkpoint.l2_norm_diff(x, y)
        assert isinstance(got, float) and got > 0
        assert abs(got - want) <= 1e-12 * want
    big = np.full(4, 3e38, np.float32)
    assert checkpoint.l2_norm_diff(big, -big) == pytest.approx(1.2e39)
    checkpoint.export_array_tsv(str(tmp_path / "u.tsv"), s.u)
    assert checkpoint.l2_norm_diff(
        checkpoint.import_array_tsv(str(tmp_path / "u.tsv"), tuple(s.u.shape), "cpu"), s.u) == 0.0


@pytest.mark.parametrize("flag", [["--renderer", "tiled"], ["--renderer", "wavefront"],
                                  ["--overflow-cap", "64"]])
def test_flags_of_unported_slices_are_refused(flag):
    """The JAX demo's flags of what the port leaves behind (the wavefront
    renderer and the slot tables' overflow cap) are refused, not
    ignored."""
    with pytest.raises(SystemExit) as e:
        main([*flag, "--device", "cpu", "--steps", "0"])
    assert e.value.code != 0


@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_demo_2d_writes_splat_frames(tmp_path, capsys, transfer, device):
    """--two-d at 16^2 for 3 steps with --render-every 1 writes
    frame2d_00000.ppm-frame2d_00002.ppm; the first is the bytes JAX's
    write_ppm writes of JAX's splat_particles_2d of the state one step of
    the port's (step2d or step_apic2d, dt = clip(dt x rate, 0, max_dt)) on
    the same device gives."""
    out = tmp_path / "out"
    assert main(["--two-d", "--transfer", transfer, "--device", device, "--grid", "16",
                 "--steps", "3", "--render-every", "1", "--width", "40", "--height", "30",
                 "--out", str(out)]) == 0
    cfg = ft.SimConfig2D(nx=16, ny=16, cells_per_meter=16.0)
    text = capsys.readouterr().out
    assert f"2D grid 16x16, {cfg.num_particles} particles on {device}" in text
    assert "step 0:" in text and "3 steps in" in text
    assert sorted(p.name for p in out.iterdir()) == [f"frame2d_{i:05d}.ppm" for i in range(3)]
    init, step = ((ft.init_apic_state2d, ft.step_apic2d) if transfer == "apic"
                  else (ft.init_state2d, ft.step2d))
    s = step(init(cfg, device), float(np.clip(1.0 / 60.0 * 0.5, 0.0, cfg.max_dt)), cfg)
    splat = jax_debug.splat_particles_2d(jnp.asarray(s.pos.cpu().numpy()), 40, 30)
    jax_write_ppm(str(tmp_path / "jax.ppm"), np.asarray(splat))
    assert (out / "frame2d_00000.ppm").read_bytes() == (tmp_path / "jax.ppm").read_bytes()


def test_debug_renderers_match_jax():
    """checkerboard, splat_particles_2d and splat_particles_3d bit for bit
    JAX's (tests/test_app.py::test_debug_renderers' views), on a background
    too; particles off the image and a NaN clip to its edge pixels in both.
    The 3D splat shades by depth, and JAX leaves the colour of a shared
    pixel undefined, so its particles have distinct pixels."""
    w, h = 64, 48
    np.testing.assert_array_equal(debug.checkerboard(w, h, device="cpu").numpy(),
                                  np.asarray(jax_debug.checkerboard(w, h)))
    np.testing.assert_array_equal(debug.checkerboard(30, 20, 5, device="cpu").numpy(),
                                  np.asarray(jax_debug.checkerboard(30, 20, 5)))
    rng = np.random.default_rng(7)
    pos2 = rng.uniform(-0.1, 1.1, size=(500, 2)).astype(np.float32)
    pos2[:3] = [[np.nan, 0.5], [0.5, np.nan], [2.0, -3.0]]
    bg = rng.random((h, w, 3)).astype(np.float32)
    for kw in ({}, {"color": (1.0, 0.5, 0.0)}):
        np.testing.assert_array_equal(
            debug.splat_particles_2d(torch.from_numpy(pos2), w, h, **kw).numpy(),
            np.asarray(jax_debug.splat_particles_2d(jnp.asarray(pos2), w, h, **kw)))
    got = debug.splat_particles_2d(torch.from_numpy(pos2), w, h, background=torch.from_numpy(bg))
    want = jax_debug.splat_particles_2d(jnp.asarray(pos2), w, h, jnp.asarray(bg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cells = rng.permutation(w * h)[:300]
    pos3 = rng.uniform(0.0, 1.0, size=(300, 3)).astype(np.float32)
    pos3[:, 0] = ((cells % w) + 0.5) / w
    pos3[:, 1] = 1.0 - ((cells // w) + 0.5) / h
    for axis in range(3):
        keep = [a for a in range(3) if a != axis]
        p = pos3[:, [*keep, axis]][:, np.argsort([*keep, axis])]
        img = debug.splat_particles_3d(torch.from_numpy(p), w, h, axis=axis).numpy()
        want = jax_debug.splat_particles_3d(jnp.asarray(p), w, h, axis)
        np.testing.assert_array_equal(img, np.asarray(want))
        assert not np.array_equal(img, debug.checkerboard(w, h, device="cpu").numpy())


def _frames_drawn(argv):
    """main(argv), recording each frame the demo renders: the camera
    vectors, the keywords it passed (width, height, t_seed, ...) and what
    render_frame returned."""
    drawn = []

    def record(label, orig, args):
        out = orig(*args)
        drawn.append((args[1:5], orig.keywords, out))
        return out

    with hooked([("app.demo", "render_frame", "render")], record):
        assert main(argv) == 0
    return drawn


@contextlib.contextmanager
def _stdin(monkeypatch, lines):
    """The demo's stdin stream (FST_DEMO_STDIN) holding ``lines``."""
    read_fd, write_fd = os.pipe()
    os.write(write_fd, "".join(line + "\n" for line in lines).encode())
    os.close(write_fd)
    monkeypatch.setenv("FST_DEMO_STDIN", "1")
    with os.fdopen(read_fd) as stdin:
        monkeypatch.setattr(sys, "stdin", stdin)
        yield


def test_demo_writes_frames_as_jax_write_ppm(tmp_path):
    """--render-every 2 for 3 steps at 12^3 writes frames 0 and 2, each the
    bytes JAX's write_ppm writes of the rendered array."""
    out = tmp_path / "out"
    drawn = _frames_drawn(["--render-every", "2", "--device", "cpu", "--grid", "12",
                           "--steps", "3", "--width", "32", "--height", "24", "--out", str(out)])
    assert sorted(p.name for p in out.iterdir()) == ["frame_00000.ppm", "frame_00002.ppm"]
    assert len(drawn) == 2
    for name, (_, kw, img) in zip(["frame_00000.ppm", "frame_00002.ppm"], drawn):
        assert (kw["width"], kw["height"]) == (32, 24) and img.shape == (24, 32, 3)
        jax_write_ppm(str(tmp_path / "jax.ppm"), img.numpy())
        assert (out / name).read_bytes() == (tmp_path / "jax.ppm").read_bytes()


def test_render_scale_gives_full_size_frame(tmp_path):
    """--render-scale 2 traces 16x12 (21x12 for 41x24, rounded up) and
    nearest-upscales to the size asked for, cropped."""
    for width, traced in [(32, 16), (41, 21)]:
        out = tmp_path / str(width)
        drawn = _frames_drawn(["--render-every", "1", "--render-scale", "2", "--device", "cpu",
                               "--grid", "12", "--steps", "1", "--width", str(width),
                               "--height", "24", "--out", str(out)])
        (_, kw, img), = drawn
        assert (kw["width"], kw["height"]) == (traced, 12)
        data = (out / "frame_00000.ppm").read_bytes()
        header = b"P6\n%d 24\n255\n" % width
        assert data.startswith(header) and len(data) == len(header) + width * 24 * 3
        pixels = np.frombuffer(data[len(header):], np.uint8).reshape(24, width, 3)
        small = (np.clip(img.numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        up = np.repeat(np.repeat(small, 2, axis=0), 2, axis=1)[:24, :width]
        np.testing.assert_array_equal(pixels, up)


def test_camera_commands_move_as_jax(tmp_path, monkeypatch, capsys):
    """'o X Y', 'z DY' and '0' on the stdin stream (FST_DEMO_STDIN) move the
    camera as JAX's OrbitCamera does, a step at a time; malformed commands
    ('o 1', 'z x') are ignored."""
    cmds = ["o 10 5", "z 3", "o 1", "o -40 12", "z x", "0", "z -2"]
    with _stdin(monkeypatch, cmds):
        drawn = _frames_drawn(["--render-every", "1", "--device", "cpu", "--grid", "8",
                               "--steps", str(len(cmds)), "--width", "16", "--height", "12",
                               "--out", str(tmp_path)])
    text = capsys.readouterr().out
    assert "ignoring malformed command: 'o 1'" in text
    assert "ignoring malformed command: 'z x'" in text
    cam = JaxCamera()
    assert len(drawn) == len(cmds)
    for cmd, (vectors, kw, _) in zip(cmds, drawn):
        name, *args = cmd.split()
        try:
            if name == "o":
                cam.orbit(float(args[0]), float(args[1]))
            elif name == "z":
                cam.zoom(float(args[0]), 12)
        except (ValueError, IndexError):
            pass
        if name == "0":
            cam.reset()
        for got, want in zip(vectors, cam.frame(kw["width"], kw["height"])):
            np.testing.assert_array_equal(got, want, err_msg=cmd)


def test_temporal_seed_cleared_on_camera_moves_and_resets(tmp_path, monkeypatch):
    """--temporal: each frame is seeded with the march ts the previous frame
    returned, but not the first, nor the one after a camera move ('o') or
    a reset ('r')."""
    cmds = ["", "", "o 5 5", "", "r", ""]
    with _stdin(monkeypatch, cmds):
        drawn = _frames_drawn(["--render-every", "1", "--temporal", "--device", "cpu", "--grid",
                               "8", "--steps", str(len(cmds)), "--width", "16", "--height", "12",
                               "--out", str(tmp_path)])
    assert len(drawn) == len(cmds)
    seeded = [kw["t_seed"] is not None for _, kw, _ in drawn]
    assert seeded == [False, True, False, True, False, True]
    for (_, _, before), (_, kw, _) in zip(drawn, drawn[1:]):
        assert kw["return_t"] is True
        if kw["t_seed"] is not None:
            assert kw["t_seed"] is before[1]


def test_demo_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device would run")
    for flags in ([], ["--two-d"], ["--two-d", "--transfer", "apic"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--grid", "8", "--steps", "1", *flags])


def test_stdin_commands_through_python_m(tmp_path):
    """`python -m fluidsimulation_tpu_torch` with FST_DEMO_STDIN: '+' then
    'q' quits after one step, before writing any checkpoint."""
    env = dict(os.environ, FST_DEMO_STDIN="1")
    proc = subprocess.run(
        [sys.executable, "-m", "fluidsimulation_tpu_torch", "--grid", "8", "--steps", "5",
         "--device", "cpu", "--out", str(tmp_path), "--save-state"],
        cwd=ROOT, input="+\nq\n", capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "1 steps in" in proc.stdout.splitlines()[-1]
    assert (tmp_path / "final_state.npz").exists()


def test_check_state_and_meter_match_jax(caplog):
    """The same verdict and the same log lines on four states: the initial
    one (phi = +inf), one step on (healthy), a NaN in phi, a fast particle."""
    j = step_jit(jax_init(JCFG), 0.01, JCFG, fast=False)
    bad_phi = ft.state_from_numpy(j, "cpu")
    bad_phi.phi[0, 0, 0] = float("nan")
    fast = ft.state_from_numpy(j, "cpu")
    fast.vel[3, 1] = 2e5
    cases = [(ft.init_state(CFG, "cpu"), False), (ft.state_from_numpy(j, "cpu"), True),
             (bad_phi, False), (fast, False)]
    for state, verdict in cases:
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            got = metrics.check_state(state)
            port_msgs = [r.getMessage() for r in caplog.records]
            caplog.clear()
            want = jax_metrics.check_state(SimpleNamespace(**ft.state_to_numpy(state)))
            jax_msgs = [r.getMessage() for r in caplog.records]
        assert got is want is verdict
        assert port_msgs == jax_msgs



def test_meter_matches_jax(monkeypatch):
    """On one fake clock both meters give the same numbers and summary."""
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    meters = [metrics.Meter(CFG.num_particles), jax_metrics.Meter(CFG.num_particles)]
    for m in meters:
        m.tick()
        m.tick(4)
    clock[0] = 102.5
    for m in meters:
        assert (m.steps, m.elapsed, m.steps_per_sec) == (5, 2.5, 2.0)
        assert m.particles_per_sec == 2.0 * CFG.num_particles
    assert meters[0].summary() == meters[1].summary() == (
        f"5 steps in 2.50s = 2.00 steps/s, {2.0 * CFG.num_particles:.3e} particles/s")
