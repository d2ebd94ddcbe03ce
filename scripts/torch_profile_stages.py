#!/usr/bin/env python3
"""Per-stage times of the PyTorch/CUDA port's frame, by prefix timing.

The port's counterpart of ``scripts/profile_stages.py``. Each prefix of
the frame is run whole through ``ops.fastpath.render_fast(...,
stop_after=s)`` for s in "prep", "sort1" (``--hoist`` only, as in JAX),
"cumsum", "expand", "sort2" and the full frame, and a stage's cost is the
difference of two prefixes. Then:

- the compositor alone (``fastpath.composite_sorted``) on the "sort2"
  outputs, forward and forward + backward (of the sum of squared rgb,
  with respect to the sorted fields);
- the full frame's forward + backward (``mean(img[..., :3] ** 2)``);
- with ``--bwd-stages``, forward + backward of each differentiable
  prefix ("prep", "expand", "sort2", full) through ``torch.autograd``:
  a stage's backward cost is its forward + backward prefix difference
  less its forward prefix difference ("cumsum" is integer-valued).

Every time is the median of ``REPEATS`` runs of ``--iters`` calls between
CUDA events (the host clock on the CPU). Defaults: the 1M-splat 1920x1080
scene. Each environment variable of the JAX script (``PROF_SPLATS``,
``PROF_W``, ``PROF_H``, ``PROF_ITERS``, ``PROF_TILE_PX``, ``PROF_CHUNK``,
``PROF_CAP``, ``PROF_SCENE``, ``PROF_SKIP_BWD``, ``PROF_BWD_STAGES``,
``PROF_DEPTH_KEY``) is the default of the flag of the same name. The last
line of standard output is one JSON object: the JAX script's keys, plus
``device`` and ``card``.

    python3 scripts/torch_profile_stages.py                  # the card
    python3 scripts/torch_profile_stages.py --bwd-stages
    python3 scripts/torch_profile_stages.py --splats 3616103 --width 1024 \\
        --height 512 --scene uniform --cap 6291456
    python3 scripts/torch_profile_stages.py --device cpu --splats 2000 \\
        --width 128 --height 64 --iters 1 --bwd-stages

``main(argv)`` runs it in-process and returns the JSON object.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--splats", type=int, default=int(env("PROF_SPLATS", "1000000")))
    ap.add_argument("--width", type=int, default=int(env("PROF_W", "1920")))
    ap.add_argument("--height", type=int, default=int(env("PROF_H", "1080")))
    ap.add_argument("--iters", type=int, default=int(env("PROF_ITERS", "20")))
    ap.add_argument("--tile-px", type=int, default=int(env("PROF_TILE_PX", "32")))
    ap.add_argument("--chunk", type=int, default=int(env("PROF_CHUNK", "256")))
    ap.add_argument("--cap", type=int, default=int(env("PROF_CAP", "0")) or None,
                    help="capacity_records (default: 3 records a splat)")
    ap.add_argument("--scene", choices=["bench", "uniform", "clustered"],
                    default=env("PROF_SCENE", "bench"))
    ap.add_argument("--skip-bwd", action="store_true",
                    default=bool(int(env("PROF_SKIP_BWD", "0"))))
    ap.add_argument("--bwd-stages", action="store_true",
                    default=bool(int(env("PROF_BWD_STAGES", "0"))))
    ap.add_argument("--depth-key", choices=["pair", "packed"],
                    default=env("PROF_DEPTH_KEY", "pair"))
    ap.add_argument("--hoist", action="store_true",
                    help="hoist_depth_sort=True (adds the 'sort1' prefix)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="run on the CUDA card (default) or on the CPU")
    return ap.parse_args(argv)


def scene_of(args):
    """The profiled scene (numpy): the 1M/1080p bench scene, the flagship's
    uniform one or the clustered one."""
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io

    if args.scene == "bench":
        return ply_io.make_synthetic_scene(args.splats, seed=42, extent=3.0,
                                           log_scale_range=(-5.5, -3.2))
    if args.scene == "uniform":
        return ply_io.make_synthetic_scene(args.splats, seed=99, extent=3.0,
                                           log_scale_range=(-5.8, -3.6))
    return ply_io.make_clustered_scene(args.splats, seed=7, extent=3.0)


def run(args):
    """(result, {"sort2": (sorted fields, bounds), "full_stats": the full
    frame's stats, "cfg": the config}) of the profile ``args`` describe."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.camera import Camera
    from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.render import camera_args
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        median_ms,
        require_device,
    )

    dev = require_device(args.device)
    card = card_line(dev)
    w, h = args.width, args.height
    log(f"device: {dev} ({card})")

    cfg = RenderConfig.for_resolution(
        w, h, tile_px=args.tile_px, use_pallas=True, chunk=args.chunk,
        dup_capacity_factor=3.0, depth_key=args.depth_key,
        hoist_depth_sort=args.hoist, capacity_records=args.cap)
    scene = scene_of(args)
    params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"}, dev)
    a = camera_args(Camera(0.0, 0.0, -8.0, width=w, height=h))
    frame = (torch.as_tensor(a["view"], device=dev), torch.as_tensor(a["vp"], device=dev),
             a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], w, h, cfg)

    def time_ms(fn):
        return median_ms(fn, dev, args.iters, REPEATS)

    def prefix(s, p=params):
        return fastpath.render_fast(p, *frame, stop_after=s)

    stages = [s for s in fastpath.STAGES if s != "sort1" or args.hoist] + [None]
    prefix_ms = {}
    with torch.no_grad():
        for s in stages:
            prefix_ms[s or "full"], _ = time_ms(lambda: prefix(s))
            log(f"prefix[{s or 'full':7s}] = {prefix_ms[s or 'full']:8.3f} ms")
        _, full_stats = prefix(None)
        _, aux = prefix("sort2")
    stage_ms, prev = {}, 0.0
    for s in stages:
        stage_ms[s or "composite"] = prefix_ms[s or "full"] - prev
        prev = prefix_ms[s or "full"]
    log("stage costs (prefix differences): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))

    sf, bounds = aux["fields"], aux["bounds"]
    t = cfg.num_tiles
    tile_ids = torch.arange(t, dtype=torch.int32, device=dev)

    def comp(fields):
        tiled, _, _ = fastpath.composite_sorted(fields, bounds, num_tiles=t,
                                                tile_ids=tile_ids, width=w,
                                                height=h, cfg=cfg)
        return tiled

    def comp_fb():
        f = sf.detach().requires_grad_(True)
        value = (comp(f)[:, :, 0:3] ** 2).sum()
        return value.detach(), torch.autograd.grad(value, f)[0]

    def grads_of(loss_at):
        q = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        value = loss_at(q)
        g = torch.autograd.grad(value, list(q.values()), allow_unused=True)
        return value.detach(), [x for x in g if x is not None]

    with torch.no_grad():
        ms_fwd, _ = time_ms(lambda: comp(sf))
    log(f"composite fwd (isolated)     = {ms_fwd:8.3f} ms")
    ms_fb = ms_full_fb = float("nan")
    bwd_table = {}
    if not args.skip_bwd:
        ms_fb, _ = time_ms(comp_fb)
        log(f"composite fwd+bwd (isolated) = {ms_fb:8.3f} ms")
        ms_full_fb, _ = time_ms(lambda: grads_of(
            lambda q: (prefix(None, q)[0][..., :3] ** 2).mean()))
        log(f"full fwd+bwd                 = {ms_full_fb:8.3f} ms")

        if args.bwd_stages:
            def loss_at(s):
                def f(q):
                    out, aux_s = prefix(s, q)
                    if s == "sort2":
                        return (aux_s["fields"] ** 2).sum()
                    if s is None:
                        return (out[..., :3] ** 2).sum()
                    return (out * out).sum()
                return f

            prev_fb = prev_fw = 0.0
            for s in ("prep", "expand", "sort2", None):
                name = s or "full"
                ms, _ = time_ms(lambda: grads_of(loss_at(s)))
                log(f"fwd+bwd prefix[{name:7s}] = {ms:8.3f} ms")
                dfb, dfw = ms - prev_fb, prefix_ms[name] - prev_fw
                prev_fb, prev_fw = ms, prefix_ms[name]
                bwd_table[s or "composite"] = dfb - dfw

    out = {"prefix_ms": prefix_ms, "stage_ms": stage_ms,
           "composite_fwd_ms": ms_fwd, "composite_fwdbwd_ms": ms_fb,
           "full_fwdbwd_ms": ms_full_fb, "bwd_stage_ms": bwd_table,
           "device": str(dev), "card": card}
    return out, {"sort2": (sf, bounds), "full_stats": full_stats, "cfg": cfg}


def main(argv=None) -> dict:
    out, _ = run(parse_args(argv))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
