#!/usr/bin/env python3
"""Streamed-viewer fps of the PyTorch/CUDA port.

The port's counterpart of ``scripts/viewer_fps_bench.py``. Starts the
interactive viewer's server (``viewer/interactive.py``) on a synthetic
scene written to a temporary PLY (capacity autotuned at the start pose, as
the viewer's ``main`` does), times render-only frames
(``Splats.render_camera_u8``, each ending in ``torch.cuda.synchronize()``
on the card), then pulls ``--frames`` frames from the continuous
``/stream`` loop over HTTP and prints one JSON line: the JAX script's keys,
plus the encoder the stream used and the device it rendered on.

    python3 scripts/torch_viewer_fps_bench.py                  # the card
    python3 scripts/torch_viewer_fps_bench.py --splats 3616103
    python3 scripts/torch_viewer_fps_bench.py --device cpu --splats 2000 \\
        --width 64 --height 64 --frames 3

``main(argv)`` runs it in-process and returns the JSON object.
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RENDER_ONLY_FRAMES = 30


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--frames", type=int, default=60,
                    help="frames pulled from /stream")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="render on the CUDA card (default) or on the CPU")
    return ap.parse_args(argv)


def _get(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=600) as r:
        return r.read()


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Camera, Splats
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.viewer import interactive

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("FATAL: no CUDA device (pass --device cpu to run on the CPU)")
    w, h = args.width, args.height
    sc = ply_io.make_synthetic_scene(args.splats, seed=5, extent=2.5)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scene.ply")
        ply_io.save_ply(path, sc["means"], sc["quats"], sc["scales"],
                        sc["opacities"], sc["colors"])
        splats = Splats(path, w, h, device=args.device)
    cam = Camera(0.0, 0.0, -6.0, width=w, height=h)
    splats.autotune_capacity(cam)
    log(f"capacity autotuned: {splats.cfg.capacity_records} records")

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    # render-bound fps: the device render and the uint8 copy to the host
    # alone -- no encode, no socket
    splats.render_camera_u8(cam, fetch_stats=False)
    sync()
    t0 = time.perf_counter()
    for _ in range(RENDER_ONLY_FRAMES):
        splats.render_camera_u8(cam, fetch_stats=False)
        sync()
    render_ms = (time.perf_counter() - t0) / RENDER_ONLY_FRAMES * 1e3
    log(f"render-only (render + u8 copy): {render_ms:.3f} ms/frame "
        f"({1e3 / render_ms:.2f} fps)")

    srv = interactive.make_server(splats, cam, port=0)
    srv.stream_max_frames = args.frames
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        _get(port, "/frame")
        # a queued key drives the movement path inside the stream loop too
        _get(port, "/key?key=d")
        n_frames = _get(port, "/stream").count(b"--gsframe")
        stats = json.loads(_get(port, "/stats"))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    out = {
        "splats": args.splats, "res": f"{w}x{h}",
        "frames_delivered": n_frames,
        "stream_fps": stats["stream_fps"],
        "render_only_ms": render_ms,
        "render_only_fps": 1e3 / render_ms,
        "records": stats.get("num_records"),
        "capacity": splats.cfg.capacity_records,
        "encoder": stats["encoder"],
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
