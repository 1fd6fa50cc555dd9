"""Live view of the demo: a small in-process HTTP server that streams the
latest frame (MJPEG) and feeds the page's mouse and key commands back into
the demo loop. Port of fluidsimulation_tpu/app/liveview.py: the same page,
command check (``_CMD_RE``) and ``/stream``.

It stands in for the reference's interactive window (FluidSimDemo.cpp:
251-293, OnMouseMove orbit and zoom, and the key handlers at
FluidSimDemo.cpp:7-13): drag orbits, the wheel zooms, and the keys + - 0 r q
are the demo's stdin commands. Commands arrive in the stdin stream's text
protocol, so the demo handles both alike.

Only the standard library is needed: ``http.server``, and a JPEG encode by
Pillow where it is installed; without Pillow each frame is a PNG encoded
with ``zlib`` (``_encode_png``). The encode runs in a ``/stream`` handler
thread, on a host copy of the frame: the handler threads never touch a
tensor, so no CUDA work happens off the demo's thread.
"""

from __future__ import annotations

import io
import re
import struct
import threading
import zlib
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

# Commands accepted from the page: the stdin stream's text protocol,
# checked here so that a malformed /cmd (a mistyped curl, or a GET fired at
# localhost by an unrelated web page) never reaches the demo's parser.
_CMD_RE = re.compile(
    r"^([+\-0rq]"
    r"|o -?\d+(\.\d+)? -?\d+(\.\d+)?"
    r"|z -?\d+(\.\d+)?)$"
)

_PAGE = """<!doctype html>
<html><head><title>fluidsimulation-tpu live view</title>
<style>
  body { background: #111; color: #ccc; font-family: monospace;
         display: flex; flex-direction: column; align-items: center; }
  img { margin-top: 1em; cursor: grab; }
  #help { margin-top: .5em; font-size: 12px; }
</style></head>
<body>
<img id="v" src="/stream" draggable="false">
<div id="help">drag: orbit &nbsp; wheel: zoom &nbsp; keys: + - speed,
0 reset view, r reset sim, q quit</div>
<script>
const img = document.getElementById('v');
let dragging = false, lx = 0, ly = 0, pdx = 0, pdy = 0, pz = 0, timer = null;
function send(c) { fetch('/cmd?c=' + encodeURIComponent(c)); }
function flush() {
  if (pdx || pdy) { send('o ' + pdx + ' ' + pdy); pdx = pdy = 0; }
  if (pz) { send('z ' + pz); pz = 0; }
  timer = null;
}
function queue() { if (!timer) timer = setTimeout(flush, 50); }
img.addEventListener('pointerdown', e => {
  dragging = true; lx = e.clientX; ly = e.clientY;
  img.setPointerCapture(e.pointerId); e.preventDefault();
});
img.addEventListener('pointerup', () => dragging = false);
img.addEventListener('pointermove', e => {
  if (!dragging) return;
  pdx += e.clientX - lx; pdy += e.clientY - ly;
  lx = e.clientX; ly = e.clientY; queue();
});
img.addEventListener('wheel', e => {
  pz += e.deltaY > 0 ? 20 : -20; queue(); e.preventDefault();
}, { passive: false });
window.addEventListener('keydown', e => {
  if ('+-0rq'.includes(e.key)) send(e.key);
  if (e.key === '=') send('+');
});
</script></body></html>"""


def _encode_png(arr: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 array as an RGB8 PNG, with zlib alone: one
    filter-0 scanline a row, deflated at level 6."""
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _quantize(arr: np.ndarray) -> np.ndarray:
    """A float frame as the demo's PPM bytes (write_ppm's rounding); a
    uint8 frame as it is."""
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(arr)


def _encode(arr: np.ndarray) -> tuple[bytes, str]:
    """(bytes, content type): a JPEG where Pillow imports, else a PNG."""
    try:
        from PIL import Image
    except ImportError:
        return _encode_png(arr), "image/png"
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=88)
    return buf.getvalue(), "image/jpeg"


class LiveView:
    """A threaded frame streamer and command inbox on ``host:port`` (port
    0 takes a free one; ``self.port`` says which). Binding a port in use
    raises OSError.

    ``publish(img)`` takes the demo's float frame (H, W, 3), values in
    [0, 1] or past it, or a uint8 one, as an array or a tensor on any
    device, and wakes every connected /stream client. It copies a tensor to
    the host and does nothing else; the quantize and encode run in a
    handler thread, once a frame, shared by all clients, so a run that no
    one watches pays nothing for them. ``poll_cmds()`` drains the checked
    commands the page posted. The server thread is a daemon; ``close()``
    stops it."""

    def __init__(self, port: int = 8000, host: str = "127.0.0.1"):
        self._cond = threading.Condition()
        self._raw: np.ndarray | None = None
        self._enc: tuple[int, bytes, str] | None = None
        self._seq = 0
        self._cmds: deque[str] = deque()
        self._cmd_lock = threading.Lock()
        view = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/cmd":
                    c = parse_qs(u.query).get("c", [""])[0].strip()
                    if c and _CMD_RE.match(c):
                        with view._cmd_lock:
                            view._cmds.append(c)
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seq = -1
                    try:
                        while True:
                            # Wait for a frame not yet sent. Before the first
                            # publish there is none: waiting on the seq alone
                            # (0 != -1) would spin here, holding the
                            # interpreter from the demo's loop.
                            with view._cond:
                                view._cond.wait_for(
                                    lambda: view._raw is not None and view._seq != seq,
                                    timeout=5.0)
                                raw, s2, enc = view._raw, view._seq, view._enc
                            if raw is None:
                                continue
                            # Encoded here, off the demo's loop, once a
                            # published frame (the seq cache).
                            if enc is not None and enc[0] == s2:
                                _, frame, ctype = enc
                            else:
                                frame, ctype = _encode(_quantize(raw))
                                with view._cond:
                                    view._enc = (s2, frame, ctype)
                            seq = s2
                            self.wfile.write(
                                b"--frame\r\nContent-Type: " + ctype.encode()
                                + b"\r\nContent-Length: " + str(len(frame)).encode()
                                + b"\r\n\r\n" + frame + b"\r\n"
                            )
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def publish(self, img) -> None:
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        arr = np.asarray(img)
        with self._cond:
            self._raw = arr
            self._seq += 1
            self._cond.notify_all()

    def poll_cmds(self) -> list[str]:
        with self._cmd_lock:
            out = list(self._cmds)
            self._cmds.clear()
        return out

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
