#!/usr/bin/env python3
"""Training throughput of the PyTorch/CUDA port: steps/s and PSNR against
step, adaptive density control on.

The port's counterpart of ``scripts/train_bench.py``, on the same protocol:

1. Ground truth: a clustered synthetic scene (``make_clustered_scene(GT,
   seed=3, extent=2.0)``) rendered from ``--views`` cameras on a ring
   facing the origin: the fitting targets, each without overflow.
2. Init: an SfM-like subsample of the GT means (jittered positions,
   nearest-neighbour scales, 0.1 opacity, grey colours) at CAP/8 splats
   (at least 1,000), drawn from ``numpy.random.default_rng(0)``.
3. Fit with ``train.densify.fit_scene_adaptive`` (clone/split/prune at the
   static capacity CAP) for ``--steps`` steps; each history entry carries
   its wall clock (taken after the step's loss reached the host), so
   steps/s over the second half and PSNR against step come from one run.
4. Holdout: PSNR at a pose outside the ring.

Each environment variable of the JAX script (``TRAIN_CAP``, ``TRAIN_GT``,
``TRAIN_RES``, ``TRAIN_VIEWS``, ``TRAIN_STEPS``, ``TRAIN_LOG_EVERY``,
``TRAIN_CPU``) is the default of the flag of the same name. The last line
of standard output is one JSON object: the JAX script's keys, plus
``device`` and ``card``.

    python3 scripts/torch_train_bench.py                    # the card
    python3 scripts/torch_train_bench.py --cap 1000000
    python3 scripts/torch_train_bench.py --device cpu --cap 2000 --gt 2000 \\
        --res 64 --views 3 --steps 20 --log-every 5

``main(argv)`` runs it in-process and returns the JSON object.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cap", type=int, default=int(env("TRAIN_CAP", "100000")),
                    help="densify capacity (static row count)")
    ap.add_argument("--gt", type=int, default=int(env("TRAIN_GT", "0")) or None,
                    help="ground-truth splats (default max(cap, 50000))")
    ap.add_argument("--res", type=int, default=int(env("TRAIN_RES", "512")),
                    help="square view resolution")
    ap.add_argument("--views", type=int, default=int(env("TRAIN_VIEWS", "12")))
    ap.add_argument("--steps", type=int, default=int(env("TRAIN_STEPS", "600")))
    ap.add_argument("--log-every", type=int, default=int(env("TRAIN_LOG_EVERY", "50")))
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    default="cpu" if env("TRAIN_CPU") else "cuda",
                    help="train on the CUDA card (default) or on the CPU")
    args = ap.parse_args(argv)
    args.gt = args.gt or max(args.cap, 50000)
    return args


def ring_cameras(views: int, w: int, h: int):
    """``views`` cameras on a circle of radius 3.5 at height 0.6, each
    turned to face the origin."""
    from openglgaussiansplattingrenderer_tpu_torch.camera import Camera

    cams = [Camera(float(3.5 * np.sin(a)), 0.6, float(-3.5 * np.cos(a)),
                   width=w, height=h)
            for a in np.linspace(0, 2 * np.pi, views, endpoint=False)]
    for c, a in zip(cams, np.linspace(0, 360, views, endpoint=False)):
        c.rotate_right(float(a))
    return cams


def gt_params(scene: dict, device):
    """The GT scene's parameters on ``device`` (SH dropped, as in JAX)."""
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy

    return params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"},
                             device)


def training_cfg(params, cam, w: int, h: int, cap: int):
    """The render config of the fit: capacity autotuned on the GT at
    ``cam`` (margin 1.6), raised to hold the training cloud at ``cap``
    rows (2.5 records a row)."""
    from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.render import (
        autotune_capacity,
        camera_args,
        quantize_capacity,
    )

    base = RenderConfig.for_resolution(w, h, tile_px=32, use_pallas=True, chunk=128)
    a = camera_args(cam)
    cfg = autotune_capacity(params, a["view"], a["vp"], a["focal_x"], a["focal_y"],
                            a["tan_fovx"], a["tan_fovy"], w, h, base, margin=1.6)
    return dataclasses.replace(cfg, capacity_records=max(
        cfg.capacity_records, quantize_capacity(int(cap * 2.5))))


def render_view(params, cam, cfg, w: int, h: int, check_overflow: bool = True):
    """The (H, W, 3) frame of ``params`` at ``cam``; raises on overflow
    where ``check_overflow``."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.render import render_stats

    with torch.no_grad():
        img, stats = render_stats(params, cam, cfg, w, h)
    if check_overflow and int(stats["overflow"]) != 0:
        raise RuntimeError(f"render capacity overflow: {int(stats['overflow'])} records")
    return img[..., :3].contiguous()


def sfm_init(gt_means: np.ndarray, cap: int):
    """The SfM-like start: max(cap // 8, 1000) GT means drawn without
    replacement by ``default_rng(0)``, jittered by N(0, 0.02), grey, at
    opacity 0.1 (``io.colmap.init_params_from_points``)."""
    from openglgaussiansplattingrenderer_tpu_torch.io.colmap import init_params_from_points

    rng = np.random.default_rng(0)
    n0 = max(cap // 8, 1000)
    idx = rng.choice(len(gt_means), n0, replace=False)
    pts = np.asarray(gt_means)[idx] + rng.normal(0, 0.02, (n0, 3))
    return init_params_from_points(pts.astype(np.float32),
                                   np.full((n0, 3), 128.0, np.float32), opacity=0.1)


def holdout_camera(w: int, h: int):
    """The held-out pose: above the ring, turned 23 and tilted 20 degrees."""
    from openglgaussiansplattingrenderer_tpu_torch.camera import Camera

    hold = Camera(0.0, 1.4, -3.3, width=w, height=h)
    hold.rotate_right(23.0)
    hold.rotate_down(20.0)
    return hold


def main(argv=None) -> dict:
    args = parse_args(argv)

    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.train import densify, losses, trainer
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        require_device,
    )

    dev = require_device(args.device)
    card = card_line(dev)
    w = h = args.res
    log(f"device: {dev} ({card}); CAP={args.cap} GT={args.gt} res={w}x{h} "
        f"views={args.views} steps={args.steps}")

    gt = ply_io.make_clustered_scene(args.gt, seed=3, extent=2.0)
    gtp = gt_params(gt, dev)
    cams = ring_cameras(args.views, w, h)
    cfg = training_cfg(gtp, cams[0], w, h, args.cap)
    log(f"render capacity {cfg.capacity_records} records")

    t0 = time.time()
    targets = [render_view(gtp, c, cfg, w, h) for c in cams]
    log(f"rendered {args.views} GT views in {time.time() - t0:.1f}s; mean luma "
        f"{float(sum(t.mean() for t in targets)) / len(targets):.4f}")

    init = sfm_init(gt["means"], args.cap)
    steps = args.steps
    dc = densify.DensifyConfig(capacity=args.cap, scene_extent=2.0, start_step=100,
                               stop_step=int(steps * 0.8), interval=100,
                               opacity_reset_interval=0)
    tc = trainer.TrainConfig(steps=steps, lr_means=2e-4, lr_means_final=2e-6,
                             lr_means_decay_steps=steps)

    t0 = time.time()
    fitted, _, history = densify.fit_scene_adaptive(
        init, targets, cams, cfg, dc, tc=tc, width=w, height=h,
        log_every=args.log_every, verbose=True, device=dev)
    total_s = time.time() - t0

    # steps/s over the second half of the run, past the first steps' warm-up
    seg = [e for e in history if e["step"] >= steps // 2]
    steps_s = ((seg[-1]["step"] - seg[0]["step"])
               / max(seg[-1]["wall_s"] - seg[0]["wall_s"], 1e-9))

    hold = holdout_camera(w, h)
    holdout_psnr = float(losses.psnr(render_view(fitted, hold, cfg, w, h, False),
                                     render_view(gtp, hold, cfg, w, h, False)))

    out = {
        "cap": args.cap, "gt_splats": args.gt, "res": f"{w}x{h}",
        "views": args.views, "steps": steps,
        "steps_per_s": steps_s,
        "ms_per_step": 1000.0 / steps_s,
        "total_s": total_s,
        "final_alive": int(history[-1]["alive"]),
        "final_train_psnr": history[-1]["psnr"],
        "holdout_psnr": holdout_psnr,
        "psnr_curve": [{"step": e["step"], "psnr": e["psnr"], "alive": e["alive"],
                        "wall_s": e["wall_s"]} for e in history],
        "device": str(dev), "card": card,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
