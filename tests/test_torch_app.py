"""The port's live view (app/liveview.py) and the demo's --serve and
--profile, on the CPU, against the JAX package.

The live view answers the page, one /stream part and /cmd as JAX's does
(tests/test_app.py::test_liveview_roundtrip); its zlib PNG, the encoder
where Pillow is missing, is JAX's bytes and decodes to the frame; its
command check gives JAX's verdicts. The demo's 3D and 2D loops take
scripted commands from a stub view: + and - change dt as JAX's loops do, r
resets, q ends the run after the commands it came with, and every frame
published is the frame written. One 3D run serves on a real socket. The
real socket and --profile are held on the card too (marked ``cuda``)."""

import re
import socket
import struct
import sys
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from fluidsimulation_tpu.app import liveview as jax_liveview
from fluidsimulation_tpu.app.demo import write_ppm as jax_write_ppm
from fluidsimulation_tpu.core.config import SimConfig as JaxConfig
from fluidsimulation_tpu.solver.step3d import clamp_dt as jax_clamp_dt

import fluidsimulation_tpu_torch as ft
from fluidsimulation_tpu_torch.app import demo, liveview
from fluidsimulation_tpu_torch.utils.profiling import MARKS, SHORT, hooked

N = 16
TIMEOUT = 10  # seconds, for every socket call
TINY = float(np.finfo(np.float32).smallest_subnormal)
# urlopen without the environment's proxies: every request here is to
# 127.0.0.1.
urlopen = urllib.request.build_opener(urllib.request.ProxyHandler({})).open


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """The demo's --device: cpu, and the card (marked cuda)."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def decode_png(data: bytes) -> np.ndarray:
    """An RGB8 PNG of filter-0 scanlines (what _encode_png writes) as an
    (H, W, 3) uint8 array; raises on anything else."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body)
        if tag == b"IHDR":
            w, h, depth, colour, *_ = struct.unpack(">IIBBBBB", body)
            assert (depth, colour) == (8, 2)
            size = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    h, w = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def read_part(resp) -> tuple[bytes, bytes]:
    """One part of a multipart /stream response: (its headers, its body)."""
    head = b""
    while not head.endswith(b"\r\n\r\n"):
        head += resp.read(1)
    length = int(re.search(rb"Content-Length: (\d+)", head).group(1))
    return head, resp.read(length)


def test_liveview_roundtrip():
    """JAX's round trip (tests/test_app.py::test_liveview_roundtrip)
    against the port's LiveView: the page, one /stream part of the
    published frame, and two commands through /cmd, a malformed one
    dropped."""
    lv = liveview.LiveView(port=0)
    try:
        img = np.random.default_rng(1).random((24, 32, 3)).astype(np.float32)
        lv.publish(torch.from_numpy(img))
        base = f"http://127.0.0.1:{lv.port}"
        page = urlopen(f"{base}/", timeout=TIMEOUT).read()
        assert b"/stream" in page and page == jax_liveview._PAGE.encode()

        r = urlopen(f"{base}/stream", timeout=TIMEOUT)
        head, body = read_part(r)
        r.close()
        assert head.startswith(b"--frame") and (b"image/jpeg" in head or b"image/png" in head)
        assert body[:2] == b"\xff\xd8" or body[:8] == b"\x89PNG\r\n\x1a\n"

        for c in ("o%2010%20-5", "%2B", "o%201", "rm%20-rf"):
            urlopen(f"{base}/cmd?c={c}", timeout=TIMEOUT).read()
        assert lv.poll_cmds() == ["o 10 -5", "+"]
        assert lv.poll_cmds() == []
        with pytest.raises(urllib.error.HTTPError):
            urlopen(f"{base}/nothing", timeout=TIMEOUT)
    finally:
        lv.close()


def test_stream_waits_for_the_first_frame():
    """A /stream opened before any frame is published waits for it: the
    handler does not spin on its condition (the JAX module's loop wakes at
    once while no frame exists, and holds the interpreter from the demo's
    step), and then sends the frame."""
    import threading

    class Counting(threading.Condition):
        waits = 0

        def wait_for(self, predicate, timeout=None):
            type(self).waits += 1
            return super().wait_for(predicate, timeout)

    lv = liveview.LiveView(port=0)
    lv._cond = Counting()
    try:
        r = urlopen(f"http://127.0.0.1:{lv.port}/stream", timeout=TIMEOUT)
        got = {}
        reader = threading.Thread(target=lambda: got.update(part=read_part(r)))
        reader.start()
        reader.join(0.5)
        assert reader.is_alive() and Counting.waits <= 2
        frame = np.random.default_rng(6).random((8, 8, 3)).astype(np.float32)
        lv.publish(frame)
        reader.join(TIMEOUT)
        assert not reader.is_alive()
        r.close()
        head, body = got["part"]
        assert head.startswith(b"--frame") and Counting.waits <= 3
    finally:
        lv.close()


def test_encode_png_matches_jax_and_decodes():
    """_encode_png writes JAX's bytes, which decode to the frame; a float
    frame is quantized as write_ppm does."""
    rng = np.random.default_rng(2)
    for h, w in ((24, 32), (1, 1), (7, 5)):
        frame = rng.random((h, w, 3)).astype(np.float32) * 1.2
        q = liveview._quantize(frame)
        np.testing.assert_array_equal(q, jax_liveview._quantize(frame))
        data = liveview._encode_png(q)
        assert data == jax_liveview._encode_png(q)
        np.testing.assert_array_equal(decode_png(data), q)
        np.testing.assert_array_equal(
            q, (np.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))


def test_png_fallback_without_pillow(monkeypatch):
    """With PIL not importable, _encode gives the PNG, and /stream serves
    it: a part that decodes to the published frame."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    frame = np.random.default_rng(3).random((12, 20, 3)).astype(np.float32)
    q = liveview._quantize(frame)
    assert liveview._encode(q) == (liveview._encode_png(q), "image/png")
    lv = liveview.LiveView(port=0)
    try:
        lv.publish(frame)
        r = urlopen(f"http://127.0.0.1:{lv.port}/stream", timeout=TIMEOUT)
        head, body = read_part(r)
        r.close()
        assert b"Content-Type: image/png" in head
        np.testing.assert_array_equal(decode_png(body), q)
    finally:
        lv.close()


CMDS = [
    ("+", True), ("-", True), ("0", True), ("r", True), ("q", True),
    ("o 10 -5", True), ("o -1.5 2.25", True), ("z 3", True), ("z -20", True), ("z 0.5", True),
    ("", False), ("x", False), ("++", False), (" q", False), ("o 1", False), ("o a b", False),
    ("o 1 2 3", False), ("o 1. 2", False), ("z", False), ("z x", False), ("z 1e3", False),
    ("0 r", False), ("q; r", False),
]


@pytest.mark.parametrize("cmd,ok", CMDS)
def test_cmd_re_gives_jax_verdicts(cmd, ok):
    assert bool(liveview._CMD_RE.match(cmd)) is ok
    assert bool(jax_liveview._CMD_RE.match(cmd)) is ok


def test_bound_port_raises():
    """A port already taken raises, as JAX's LiveView does: no run without
    its view."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        port = s.getsockname()[1]
        with pytest.raises(OSError):
            liveview.LiveView(port=port)
        with pytest.raises(OSError):
            demo.main(["--device", "cpu", "--grid", "8", "--steps", "1", "--serve", str(port)])


class ScriptedView:
    """A stub LiveView: poll_cmds returns the script's next list of
    commands (then none), publish keeps a copy of each frame."""

    script: list = []
    made: list = []

    def __init__(self, port, host="127.0.0.1"):
        self.port, self.published, self.closed = port, [], False
        self._script = iter(type(self).script)
        type(self).made.append(self)

    def poll_cmds(self):
        return list(next(self._script, []))

    def publish(self, img):
        self.published.append(np.array(img))

    def close(self):
        self.closed = True


def jax_rates(script, rate, steps):
    """The rate each step runs at under JAX's loop rules (+ doubles up to
    1, - halves down to the smallest float32 subnormal), until 'q'."""
    out = []
    for i in range(steps):
        cmds = script[i] if i < len(script) else []
        for c in cmds:
            if c == "+":
                rate = min(rate * 2.0, 1.0)
            elif c == "-":
                rate = max(rate / 2.0, TINY)
        if "q" in cmds:
            break
        out.append(rate)
    return out


def scripted_run(monkeypatch, tmp_path, script, argv, step_attr):
    """demo.main(argv) with the stub view scripted; returns (the view, the
    (state, dt) each step was called with)."""
    monkeypatch.setattr(ScriptedView, "script", script)
    monkeypatch.setattr(ScriptedView, "made", [])
    monkeypatch.setattr(demo, "LiveView", ScriptedView)
    calls = []

    def record(label, orig, args):
        calls.append((args[0], args[1]))
        return orig(*args)

    with hooked([("app.demo", step_attr, "step")], record):
        assert demo.main([*argv, "--serve", "8123", "--device", "cpu", "--out", str(tmp_path)]) == 0
    (view,) = ScriptedView.made
    assert view.closed and view.port == 8123
    return view, calls


def check_published(view, tmp_path, names):
    """Each frame published is the frame written: JAX's write_ppm of it
    gives the PPM's bytes."""
    assert len(view.published) == len(names)
    for img, name in zip(view.published, names):
        jax_write_ppm(str(tmp_path / "jax.ppm"), img)
        assert (tmp_path / name).read_bytes() == (tmp_path / "jax.ppm").read_bytes()


def test_3d_loop_takes_scripted_commands(monkeypatch, tmp_path):
    """+, - (clamped at the smallest subnormal), 0, o, z change dt and the
    camera as JAX's loop does; r resets the state; q ends the run after the
    commands it arrived with (the r beside it resets the saved state)."""
    script = [[], ["+"], ["-", "-", "-"], ["r"], ["-"] * 160, ["o 5 5", "z 3", "0"], ["+"],
              ["+", "r", "q"]]
    cfg = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N))
    view, calls = scripted_run(monkeypatch, tmp_path, script,
                               ["--grid", str(N), "--steps", "12", "--render-every", "1",
                                "--width", "16", "--height", "12", "--save-state"], "step")
    rates = jax_rates(script, 0.5, 12)
    assert len(calls) == len(rates) == 7
    jcfg = JaxConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N))
    assert [dt for _, dt in calls] == [jax_clamp_dt(jcfg, 1.0 / 60.0, r) for r in rates]
    assert rates[4] == TINY
    init = ft.init_state(cfg, "cpu")
    assert torch.equal(calls[3][0].pos, init.pos) and not torch.equal(calls[2][0].pos, init.pos)
    check_published(view, tmp_path, [f"frame_{i:05d}.ppm" for i in range(7)])
    saved = np.load(tmp_path / "final_state.npz")
    np.testing.assert_array_equal(saved["pos"], init.pos.numpy())


@pytest.mark.parametrize("apic", [False, True], ids=["flip", "apic"])
def test_2d_loop_takes_scripted_commands(monkeypatch, tmp_path, apic):
    """--two-d: + and - change dt as JAX's _main_2d does, r resets, the
    camera commands do nothing, q ends the run; every splat frame is
    published."""
    script = [["+"], ["-", "-", "0", "o 1 1", "z 2"], ["r"], [], ["-", "q"]]
    cfg = ft.SimConfig2D(nx=N, ny=N, cells_per_meter=float(N))
    argv = ["--two-d", "--grid", str(N), "--steps", "9", "--render-every", "1", "--width", "20",
            "--height", "16", "--transfer", "apic" if apic else "flip"]
    view, calls = scripted_run(monkeypatch, tmp_path, script, argv,
                               "step_apic2d" if apic else "step2d")
    rates = jax_rates(script, 0.5, 9)
    assert len(calls) == len(rates) == 4
    assert [dt for _, dt in calls] == [
        float(np.clip(1.0 / 60.0 * r, 0.0, cfg.max_dt)) for r in rates]
    init = (ft.init_apic_state2d if apic else ft.init_state2d)(cfg, "cpu")
    assert torch.equal(calls[2][0].pos, init.pos) and not torch.equal(calls[1][0].pos, init.pos)
    check_published(view, tmp_path, [f"frame2d_{i:05d}.ppm" for i in range(4)])


def test_serve_on_a_real_socket(monkeypatch, tmp_path, device):
    """--serve on a free port, 16^3, a frame a step: at step 1 a client
    reads the page and one /stream part (a PNG, Pillow hidden: the first
    frame's PPM pixels) and posts 'o 10 -5' and '+'; at step 2 it posts
    'q', so the run ends after 3 steps of the 20 asked for."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    seen = {}

    def client(label, orig, args):
        i = len(seen.setdefault("dts", []))
        seen["dts"].append(args[1])
        if i == 1:
            seen["page"] = urlopen(f"{base}/", timeout=TIMEOUT).read()
            r = urlopen(f"{base}/stream", timeout=TIMEOUT)
            seen["part"] = read_part(r)
            r.close()
            for c in ("o%2010%20-5", "%2B"):
                urlopen(f"{base}/cmd?c={c}", timeout=TIMEOUT).read()
        if i == 2:
            urlopen(f"{base}/cmd?c=q", timeout=TIMEOUT).read()
        return orig(*args)

    with hooked([("app.demo", "step", "step")], client):
        assert demo.main(["--device", device, "--grid", str(N), "--steps", "20", "--render-every",
                          "1", "--width", "32", "--height", "24", "--serve", str(port),
                          "--out", str(tmp_path)]) == 0
    cfg = ft.SimConfig(nx=N, ny=N, nz=N, cells_per_meter=float(N))
    assert seen["dts"] == [jax_clamp_dt(cfg, 1.0 / 60.0, r) for r in (0.5, 0.5, 1.0)]
    assert b"/stream" in seen["page"]
    head, body = seen["part"]
    assert b"image/png" in head
    ppm = (tmp_path / "frame_00000.ppm").read_bytes()
    header = b"P6\n32 24\n255\n"
    np.testing.assert_array_equal(
        decode_png(body), np.frombuffer(ppm[len(header):], np.uint8).reshape(24, 32, 3))
    with pytest.raises(OSError):  # the view is closed
        urlopen(f"{base}/", timeout=TIMEOUT)


@pytest.mark.parametrize("transfer", ["flip", "apic"])
def test_profile_prints_one_table_a_step(tmp_path, capsys, transfer, device):
    """--profile: a table of the 23 marks and a step line each step, DRAW
    nonzero on the rendering steps only; in --two-d it prints none."""
    assert demo.main(["--profile", "--device", device, "--grid", str(N), "--steps", "3",
                      "--render-every", "2", "--width", "16", "--height", "12", "--transfer",
                      transfer, "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    heads = [i for i, line in enumerate(lines) if line.startswith("GPU time:\tA ")]
    assert len(heads) == 3
    for step, i in enumerate(heads):
        assert lines[i].split("\t")[1:] == [f"{s:<6}" for s in SHORT]
        vals = lines[i + 1].split("\t")
        assert vals[0] == "GPU time:" and len(vals) == 1 + len(MARKS)
        ms = dict(zip(MARKS, (float(v.removesuffix("ms")) for v in vals[1:])))
        assert (ms["DRAW"] > 0) is (step % 2 == 0)
        assert lines[i + 2].startswith(f"step {step}: ")
    assert demo.main(["--two-d", "--profile", "--device", device, "--grid", str(N), "--steps",
                      "2", "--out", str(tmp_path)]) == 0
    assert "GPU time:" not in capsys.readouterr().out
