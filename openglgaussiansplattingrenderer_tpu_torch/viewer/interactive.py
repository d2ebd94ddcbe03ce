"""Interactive browser viewer: the reference's GLFW window, over HTTP.

Counterpart of ``openglgaussiansplattingrenderer_tpu/viewer/interactive.py``.
The reference app is interactive -- WASD/space/shift move, arrows rotate,
ESC quits, C triggers the CPU render (``main.cpp:52-89``,
``Camera::getInput``, ``Camera.cpp:77-119``). A GPU host in a rack has no
display, so this serves the same loop to a browser: an HTML page captures
key presses and fetches re-rendered frames; the server applies the
reference's exact movement steps (0.1 units, 1 degree) to the same Camera.

Two modes:

- ``/`` -- request-response: one PNG per key press (``/frame?key=...``).
- ``/live`` -- the reference's continuous render loop: ``/stream`` serves a
  multipart/x-mixed-replace stream that re-renders continuously; key
  presses land via ``/key`` and take effect on the next frame; the server
  measures the delivered fps (EWMA over frame gaps, the analogue of the
  reference's per-frame ``GL_TIMESTAMP`` prints, main.cpp:60-77) and
  reports it at ``/stats`` and in the page overlay.

Frames are encoded by PIL where it is installed (JPEG for the stream, PNG
for ``/frame``) and otherwise as PNG by ``io.png.encode_png``, in memory;
``/stats`` names the encoder (``"encoder"``).

Usage:
    python3 -m openglgaussiansplattingrenderer_tpu_torch.viewer.interactive scene.ply
then open http://localhost:8000/ (or /live for the streamed mode). The
frames render on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from openglgaussiansplattingrenderer_tpu_torch.io import png as png_io

PAGE = b"""<!doctype html>
<html><head><title>gsplat-tpu viewer</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
img { image-rendering:pixelated; border:1px solid #333 }
</style></head><body>
<h3>gsplat-tpu interactive viewer</h3>
<div>WASD move &middot; space/shift up/down &middot; arrows rotate &middot;
C = golden render &middot; stats below</div>
<img id="v" width="75%">
<pre id="s"></pre>
<script>
let busy = false;
async function frame(key) {
  if (busy) return; busy = true;
  const r = await fetch('/frame' + (key ? '?key=' + key : ''));
  const meta = JSON.parse(r.headers.get('x-stats') || '{}');
  document.getElementById('s').textContent = JSON.stringify(meta);
  const blob = await r.blob();
  document.getElementById('v').src = URL.createObjectURL(blob);
  busy = false;
}
document.addEventListener('keydown', (e) => {
  const map = {'w':'w','a':'a','s':'s','d':'d',' ':'space','Shift':'shift',
               'ArrowLeft':'left','ArrowRight':'right','ArrowUp':'up',
               'ArrowDown':'down','c':'c'};
  if (map[e.key] !== undefined) { e.preventDefault(); frame(map[e.key]); }
});
frame();
</script></body></html>"""

LIVE_PAGE = b"""<!doctype html>
<html><head><title>gsplat-tpu live viewer</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
img { image-rendering:pixelated; border:1px solid #333 }
</style></head><body>
<h3>gsplat-tpu live viewer (streamed)</h3>
<div>WASD move &middot; space/shift up/down &middot; arrows rotate &middot;
measured fps + stats below</div>
<img id="v" src="/stream" width="75%">
<pre id="s"></pre>
<script>
document.addEventListener('keydown', (e) => {
  const map = {'w':'w','a':'a','s':'s','d':'d',' ':'space','Shift':'shift',
               'ArrowLeft':'left','ArrowRight':'right','ArrowUp':'up',
               'ArrowDown':'down'};
  if (map[e.key] !== undefined) {
    e.preventDefault(); fetch('/key?key=' + map[e.key]);
  }
});
setInterval(async () => {
  const r = await fetch('/stats');
  document.getElementById('s').textContent =
      JSON.stringify(await r.json());
}, 500);
</script></body></html>"""


def apply_key(camera, key: Optional[str]) -> None:
    """Reference key handling (Camera::getInput, Camera.cpp:77-119): 0.1
    units a move, 1 degree a turn; any other key leaves the camera as it
    is."""
    if key == "w":
        camera.move_forward(0.1)
    elif key == "s":
        camera.move_backward(0.1)
    elif key == "a":
        camera.move_left(0.1)
    elif key == "d":
        camera.move_right(0.1)
    elif key == "space":
        camera.move_up(0.1)
    elif key == "shift":
        camera.move_down(0.1)
    elif key == "left":
        camera.rotate_left(1.0)
    elif key == "right":
        camera.rotate_right(1.0)
    elif key == "up":
        camera.rotate_up(1.0)
    elif key == "down":
        camera.rotate_down(1.0)


def _have_pil() -> bool:
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return False
    return True


def encode_frame(img, fmt: str) -> bytes:
    """(H, W, 3|4) float or uint8 frame -> ``fmt`` ("PNG" or "JPEG") bytes
    of its RGB: PIL where it is installed, else ``encode_png`` (PNG only)."""
    arr = png_io.to_uint8(np.asarray(img)[..., :3])
    if _have_pil():
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, fmt)
        return buf.getvalue()
    if fmt != "PNG":
        raise ValueError(f"{fmt} needs PIL; without it frames are PNG")
    return png_io.encode_png(arr)


def encoder_name(fmt: str) -> str:
    """Which encoder ``encode_frame(img, fmt)`` runs."""
    return f"PIL {fmt}" if _have_pil() else "encode_png"


def stream_format():
    """(format, content type) of the stream's frames: JPEG with PIL, else
    PNG."""
    return ("JPEG", "image/jpeg") if _have_pil() else ("PNG", "image/png")


def _stats_json(stats) -> dict:
    return {k: np.asarray(v).tolist() for k, v in (stats or {}).items()}


class ViewerState:
    def __init__(self, splats, camera):
        self.splats = splats
        self.camera = camera
        self.lock = threading.Lock()
        self.pending: list = []        # queued /key presses for the stream
        self.stream_fps = 0.0          # EWMA of delivered stream frame rate
        self.stream_frames = 0
        self.last_stats_json: dict = {}
        self._last_frame_t: Optional[float] = None

    def _pose(self) -> dict:
        return {"pos": [round(float(v), 3) for v in self.camera.position],
                "rot": [round(float(v), 1) for v in self.camera.rotation]}

    def render_png(self, key: Optional[str]):
        """Apply ``key``, render and PNG-encode one frame: (bytes, stats).
        The C key renders through the numpy golden pipeline
        (``Splats.cpu_render``), as the reference's C key runs its CPU
        render."""
        from openglgaussiansplattingrenderer_tpu_torch.render import camera_args

        with self.lock:
            apply_key(self.camera, key)
            if key == "c":
                a = camera_args(self.camera)
                img = self.splats.cpu_render(
                    a["view"], self.camera.width, self.camera.height,
                    a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"],
                    a["vp"], save_path=None)
                stats = {"path": "golden"}
            else:
                img = self.splats.render_camera(self.camera)
                stats = _stats_json(self.splats.last_stats)
            stats.update(self._pose())
            stats["encoder"] = encoder_name("PNG")
        return encode_frame(img, "PNG"), stats

    def render_stream_frame(self):
        """One frame of the continuous loop: apply the queued keys, render
        to uint8 on the device, encode. Returns (bytes, content type)."""
        fmt, ctype = stream_format()
        with self.lock:
            keys, self.pending = self.pending, []
            for k in keys:
                apply_key(self.camera, k)
            # the frame's stats are fetched from the device only every
            # 10th frame: each fetch is a host sync of a dozen scalars
            img = self.splats.render_camera_u8(
                self.camera, fetch_stats=(self.stream_frames % 10 == 0))
            # delivered fps = gap between consecutive frames (render +
            # encode + socket write of the previous one): what the browser
            # sees
            now = time.perf_counter()
            last, self._last_frame_t = self._last_frame_t, now
            self.stream_frames += 1
            if last is not None:
                inst = 1.0 / max(now - last, 1e-6)
                self.stream_fps = (inst if self.stream_frames == 2
                                   else 0.9 * self.stream_fps + 0.1 * inst)
            stats = _stats_json(self.splats.last_stats)
            stats["pos"] = self._pose()["pos"]
            stats["stream_fps"] = round(self.stream_fps, 2)
            stats["stream_frames"] = self.stream_frames
            stats["encoder"] = encoder_name(fmt)
            self.last_stats_json = stats
        return encode_frame(img, fmt), ctype


def make_server(splats, camera, port: int = 8000) -> ThreadingHTTPServer:
    """The viewer's HTTP server on 127.0.0.1:``port`` (0 picks a free one).
    ``server.state`` is its ``ViewerState``; ``server.stream_max_frames``
    (None: until the client leaves) bounds a ``/stream``."""
    state = ViewerState(splats, camera)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, ctype: str, body: bytes, headers=()) -> None:
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            key = parse_qs(url.query).get("key", [None])[0]
            if url.path == "/":
                self._send("text/html", PAGE)
            elif url.path == "/frame":
                png, stats = state.render_png(key)
                self._send("image/png", png, [("X-Stats", json.dumps(stats))])
            elif url.path == "/live":
                self._send("text/html", LIVE_PAGE)
            elif url.path == "/key":
                if key:
                    with state.lock:
                        state.pending.append(key)
                self.send_response(204)
                self.end_headers()
            elif url.path == "/stats":
                self._send("application/json",
                           json.dumps(state.last_stats_json).encode())
            elif url.path == "/stream":
                # the reference's while(!glfwWindowShouldClose) frame loop
                # (main.cpp:52-89), ended by the client disconnecting
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=gsframe")
                self.end_headers()
                max_frames = server.stream_max_frames
                n = 0
                try:
                    while max_frames is None or n < max_frames:
                        frame, ctype = state.render_stream_frame()
                        self.wfile.write(b"--gsframe\r\n")
                        self.wfile.write(f"Content-Type: {ctype}\r\n"
                                         f"Content-Length: {len(frame)}\r\n\r\n"
                                         .encode())
                        self.wfile.write(frame)
                        self.wfile.write(b"\r\n")
                        n += 1
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_response(404)
                self.end_headers()

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.state = state
    server.stream_max_frames = None
    return server


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Serve a 3DGS PLY to a browser.")
    ap.add_argument("scene")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="render on the CUDA card (default) or on the CPU")
    ap.add_argument("--no-autotune", action="store_true",
                    help="skip the startup capacity autotune probe")
    args = ap.parse_args(argv)

    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Splats
    from openglgaussiansplattingrenderer_tpu_torch.camera import default_camera

    if args.device == "cuda" and not torch.cuda.is_available():
        print("FATAL: no CUDA device (pass --device cpu to render on the CPU)",
              file=sys.stderr)
        return 1
    splats = Splats(args.scene, args.width, args.height, device=args.device)
    cam = default_camera(args.width, args.height)
    if not args.no_autotune:
        # pin record capacity to the start pose's measured count (+margin);
        # a camera move that overflows it shows up in stats["overflow"]
        splats.autotune_capacity(cam)
    server = make_server(splats, cam, args.port)
    print(f"viewing {args.scene} at http://localhost:{args.port}/ "
          "(request-response; /live streams continuously with measured fps)")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
