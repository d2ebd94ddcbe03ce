#!/usr/bin/env python3
"""Flagship frame rate of the PyTorch/CUDA port: the reference's own
operating point, forward (and optionally forward + backward).

The port's counterpart of ``scripts/flagship_bench.py``: 3,616,103 splats
(the reference's bike-big.ply) at its default 1024x512, on two scenes:

- **uniform**: ``make_synthetic_scene(N, seed=99, extent=3.0,
  log_scale_range=(-5.8, -3.6))``, near-uniform tile occupancy;
- **clustered**: ``make_clustered_scene(N, seed=7, extent=3.0)``, the
  heavy-tailed occupancy of real captures.

Capacity is autotuned per scene (``render.autotune_capacity``) and the
larger of the two is shared, one record-sort length for both. Each scene's
frame is timed ``--iters`` calls at a time, median of 3 (CUDA events on
the card), after a check of zero overflow; with ``--bwd`` also the forward
+ backward of ``mean(img[..., :3] ** 2)``. One JSON line a scene, then the
headline ``fps_flagship_1024x512_fwd``: the worse scene's fps, against the
30 fps bar.

Sort configurations: ``--depth-key pair|packed``, ``--hoist``,
``--sort-payload q16`` (packed only; forward only: its backward raises by
design). Each environment variable of the JAX script (``FLAGSHIP_SPLATS``,
``FLAGSHIP_ITERS``, ``FLAGSHIP_TILE_PX``, ``FLAGSHIP_CHUNK``,
``FLAGSHIP_BWD``, ``FLAGSHIP_HOIST``, ``FLAGSHIP_DEPTH_KEY``,
``FLAGSHIP_SORT_PAYLOAD``, ``FLAGSHIP_CPU``) is the default of the flag
of the same name. Every JSON line carries ``device`` and ``card``.

    python3 scripts/torch_flagship_bench.py                  # the card
    python3 scripts/torch_flagship_bench.py --bwd
    python3 scripts/torch_flagship_bench.py --depth-key packed --sort-payload q16
    python3 scripts/torch_flagship_bench.py --device cpu --splats 2000 \\
        --width 128 --height 64 --iters 1

``main(argv)`` runs it in-process and returns the headline object.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=int(env("FLAGSHIP_SPLATS", "3616103")))
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--iters", type=int, default=int(env("FLAGSHIP_ITERS", "20")))
    ap.add_argument("--tile-px", type=int, default=int(env("FLAGSHIP_TILE_PX", "32")))
    ap.add_argument("--chunk", type=int, default=int(env("FLAGSHIP_CHUNK", "128")))
    ap.add_argument("--bwd", action="store_true",
                    default=bool(int(env("FLAGSHIP_BWD", "0"))),
                    help="also time forward + backward")
    ap.add_argument("--hoist", action="store_true",
                    default=bool(int(env("FLAGSHIP_HOIST", "0"))),
                    help="hoist_depth_sort=True")
    ap.add_argument("--depth-key", choices=["pair", "packed"],
                    default=env("FLAGSHIP_DEPTH_KEY", "pair"))
    ap.add_argument("--sort-payload", choices=["f32", "q16"],
                    default=env("FLAGSHIP_SORT_PAYLOAD", "f32"),
                    help="q16: the packed-payload inference mode (packed key)")
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    default="cpu" if env("FLAGSHIP_CPU") else "cuda",
                    help="render on the CUDA card (default) or on the CPU")
    return ap.parse_args(argv)


def scenes(n: int):
    """name -> scene maker, the two flagship scene statistics."""
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io

    return {
        "uniform": lambda: ply_io.make_synthetic_scene(
            n, seed=99, extent=3.0, log_scale_range=(-5.8, -3.6)),
        "clustered": lambda: ply_io.make_clustered_scene(n, seed=7, extent=3.0),
    }


def run(args):
    """(headline, {scene: result}) of the bench ``args`` describe."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.camera import Camera
    from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.render import (
        autotune_capacity,
        camera_args,
        render_arrays,
    )
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        fence,
        median_ms,
        require_device,
    )

    if args.bwd and args.sort_payload == "q16":
        raise SystemExit("FATAL: sort_payload='q16' is an inference mode: the port's "
                         "q16 backward raises by design; drop --bwd")
    dev = require_device(args.device)
    card = card_line(dev)
    w, h = args.width, args.height
    log(f"device: {dev} ({card})")

    a = camera_args(Camera(0.0, 0.0, -8.0, width=w, height=h))
    view = torch.as_tensor(a["view"], device=dev)
    vp = torch.as_tensor(a["vp"], device=dev)
    cam_f = (a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])
    base = RenderConfig.for_resolution(
        w, h, tile_px=args.tile_px, use_pallas=True, chunk=args.chunk,
        hoist_depth_sort=args.hoist, depth_key=args.depth_key,
        sort_payload=args.sort_payload)
    log(f"grid {base.grid_x}x{base.grid_y} ({base.num_tiles} tiles)")

    params_by_scene, caps = {}, {}
    for name, make in scenes(args.splats).items():
        sc = make()
        params = params_from_numpy({k: v for k, v in sc.items() if k != "sh_rest"}, dev)
        params_by_scene[name] = params
        caps[name] = autotune_capacity(params, view, vp, *cam_f, w, h,
                                       base).capacity_records
        log(f"{name}: autotuned capacity {caps[name]}")
    cap = max(caps.values())
    cfg = dataclasses.replace(base, capacity_records=cap)
    log(f"shared capacity bucket: {cap}")

    def fwd(p):
        with torch.no_grad():
            return render_arrays(p, view, vp, *cam_f, w, h, cfg)

    def fwd_bwd(p):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        img, _ = render_arrays(q, view, vp, *cam_f, w, h, cfg)
        loss = (img[..., :3] ** 2).mean()
        return loss, torch.autograd.grad(loss, list(q.values()))

    results = {}
    for name, params in params_by_scene.items():
        t0 = time.time()
        img, stats = fwd(params)
        fence(img)
        st = {k: v.item() for k, v in stats.items()}
        log(f"{name}: first frame {time.time() - t0:.1f}s; stats {st}")
        if st["overflow"] != 0:
            raise RuntimeError(f"{name}: capacity overflow {st['overflow']}")
        fwd_ms, _ = median_ms(lambda: fwd(params)[0], dev, args.iters, REPEATS)
        out = {"scene": name, "fwd_ms": fwd_ms, "fps": 1000 / fwd_ms,
               "capacity": cap, "records": st["num_records"],
               "binned": st["binned_records"], "max_bin": st["max_bin"],
               "mean_bin": st["mean_bin"]}
        if args.bwd:
            out["fwdbwd_ms"], _ = median_ms(lambda: fwd_bwd(params), dev,
                                            args.iters, REPEATS)
        out.update(device=str(dev), card=card)
        log(f"{name}: fwd {fwd_ms:.3f} ms ({1000 / fwd_ms:.2f} fps)")
        results[name] = out
        print(json.dumps(out), flush=True)

    # the headline: the worse of the two scene statistics
    worst = min(results.values(), key=lambda r: r["fps"])
    headline = {"metric": "fps_flagship_1024x512_fwd", "value": worst["fps"],
                "unit": "fps", "vs_baseline": worst["fps"] / 30.0,
                "device": str(dev), "card": card}
    return headline, results


def main(argv=None) -> dict:
    headline, _ = run(parse_args(argv))
    print(json.dumps(headline), flush=True)
    return headline


if __name__ == "__main__":
    main()
