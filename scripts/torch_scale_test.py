#!/usr/bin/env python3
"""Real-capture scale for the PyTorch/CUDA port: bike-big.ply's splat count
through the PLY writer, the native loader and a 1080p frame.

The port's counterpart of ``scripts/scale_test.py``. A synthetic scene of
3,616,103 splats (the reference's bike-big.ply; ``make_synthetic_scene(N,
seed=99, extent=3.0, log_scale_range=(-5.8, -3.6))``) is written with
``io.ply.save_ply`` into a temporary directory, or ``--ply PATH`` is read
as it is where that file exists (and written there first where it does
not), and read back with the native C++ loader (``io.native``; the
script fails where it cannot be built, never falling back to the Python
reader). Then forward and forward + backward of ``mean(img[..., :3] **
2)`` at 1920x1080 with ``dup_capacity_factor=2.2``, ``ITERS`` calls each
(CUDA events on the card), with the overflow and whether every gradient
is finite. ``SCALE_SPLATS`` is the default of ``--splats``. The last line
of standard output is one JSON object: the JAX script's keys, plus
``device`` and ``card``.

    python3 scripts/torch_scale_test.py                      # the card
    python3 scripts/torch_scale_test.py --splats 6000000
    python3 scripts/torch_scale_test.py --device cpu --splats 2000 \\
        --width 128 --height 72

``main(argv)`` runs it in-process and returns the JSON object.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ITERS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int,
                    default=int(os.environ.get("SCALE_SPLATS", "3616103")))
    ap.add_argument("--ply", help="PLY to read (written first if it does not exist); "
                    "default: a temporary file, deleted after")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="render on the CUDA card (default) or on the CPU")
    return ap.parse_args(argv)


def write_scene(path: str, n: int):
    """Write the scale scene of ``n`` splats to ``path``; returns it."""
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io

    t0 = time.time()
    scene = ply_io.make_synthetic_scene(n, seed=99, extent=3.0,
                                        log_scale_range=(-5.8, -3.6))
    ply_io.save_ply(path, scene["means"], scene["quats"], scene["scales"],
                    scene["opacities"], scene["colors"])
    log(f"wrote {path} ({os.path.getsize(path) / 1e6:.0f} MB) in "
        f"{time.time() - t0:.1f}s")
    return scene


def load_native(path: str):
    """(params (numpy), seconds) from the native loader; raises where it
    cannot be built."""
    from openglgaussiansplattingrenderer_tpu_torch.io import native

    if not native.available():
        raise RuntimeError("the native PLY loader could not be built (g++); "
                           "this script does not fall back to the Python reader")
    t0 = time.time()
    params = native.load_splats(path, 255.0)
    return params, time.time() - t0


def run(args):
    """(result, {"written": the scene written or None, "loaded": the
    loader's numpy params})."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.camera import Camera
    from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        fence,
        median_ms,
        require_device,
    )

    dev = require_device(args.device)
    card = card_line(dev)
    w, h = args.width, args.height
    log(f"device: {dev} ({card})")

    with tempfile.TemporaryDirectory() as tmp:
        path = args.ply or os.path.join(tmp, f"scale_synth_{args.splats}.ply")
        written = None if os.path.exists(path) else write_scene(path, args.splats)
        params_np, load_s = load_native(path)
    n = params_np["means"].shape[0]
    if n != args.splats:
        raise RuntimeError(f"{path} holds {n} splats, not {args.splats}")
    log(f"native loader: {n} splats in {load_s:.2f}s ({n / load_s / 1e6:.1f} Msplat/s)")

    cfg = RenderConfig.for_resolution(w, h, tile_px=32, use_pallas=True, chunk=128,
                                      dup_capacity_factor=2.2)
    log(f"capacity {cfg.capacity(n)} records")
    params = params_from_numpy({k: v for k, v in params_np.items() if k != "sh_rest"},
                               dev)
    a = camera_args(Camera(0.0, 0.0, -8.0, width=w, height=h))
    view = torch.as_tensor(a["view"], device=dev)
    vp = torch.as_tensor(a["vp"], device=dev)
    cam_f = (a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])

    def fwd():
        with torch.no_grad():
            return render_arrays(params, view, vp, *cam_f, w, h, cfg)

    def fwd_bwd():
        q = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        img, _ = render_arrays(q, view, vp, *cam_f, w, h, cfg)
        loss = (img[..., :3] ** 2).mean()
        return loss.detach(), dict(zip(q, torch.autograd.grad(loss, list(q.values()))))

    t0 = time.time()
    img, stats = fwd()
    fence(img)
    log(f"fwd first frame {time.time() - t0:.1f}s; stats "
        f"{ {k: v.item() for k, v in stats.items()} }")
    overflow = int(stats["overflow"])
    fwd_ms, _ = median_ms(lambda: fwd()[0], dev, ITERS, 1)
    fb_ms, (loss, grads) = median_ms(fwd_bwd, dev, ITERS, 1)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    log(f"fwd {fwd_ms:.3f} ms/frame ({1000 / fwd_ms:.2f} fps), fwd+bwd "
        f"{fb_ms:.3f} ms/frame, loss {float(loss):.6f}, grads finite: {finite}, "
        f"overflow {overflow}")
    out = {"num_splats": n, "native_load_s": load_s,
           "fwd_ms": fwd_ms, "fwdbwd_ms": fb_ms, "fwd_fps": 1000 / fwd_ms,
           "overflow": overflow, "grads_finite": finite,
           "device": str(dev), "card": card}
    return out, {"written": written, "loaded": params_np}


def main(argv=None) -> dict:
    out, _ = run(parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
