#!/usr/bin/env python3
"""Novel-view quality of the PyTorch/CUDA port: many-view training with
adaptive density control, and the PSNR and SSIM of poses it never saw.

The port's counterpart of ``scripts/novel_view_bench.py``, on the same
protocol:

1. GT: a clustered synthetic scene (``make_clustered_scene(GT, seed=3,
   extent=2.0)``; ``--gt-colors correlated`` replaces its random colours
   by a smooth positional field), rendered from ``--poses`` poses on two
   interleaved rings facing the origin (``make_poses``). Every
   ``--holdout-every``-th pose is held out: by default 72 poses, 64 to
   train on and 8 to hold out.
2. Init: the SfM-like subsample at CAP/8 of ``torch_train_bench.sfm_init``.
3. Train with adaptive density control to CAP in ``--segment``-step
   chunks, each a call of ``train.densify.fit_scene_adaptive`` that
   resumes the checkpoint the chunk before wrote (``--ckpt``; a resumed
   run replays the uninterrupted one bit for bit), and score the holdout
   poses after each chunk: the holdout curve.
4. Artifact: a GT | fit grid over 4 holdout poses (``--grid``).

``--bf16-grads`` rounds the field cotangents to bf16 in pairs through the
record sort's backward (``records.BWD_COT_PACK = "bf16"``, as
``GS_BWD_SORT=bf16`` sets it): the JAX package's cotangent mode.

Each environment variable of the JAX script (``NV_CAP``, ``NV_GT``,
``NV_RES``, ``NV_POSES``, ``NV_HOLDOUT_EVERY``, ``NV_STEPS``,
``NV_SEGMENT``, ``NV_GRAD_THRESHOLD``, ``NV_CKPT``, ``NV_GRID``,
``NV_GT_COLORS``, ``NV_OPACITY_RESET``, ``NV_CPU``) is the default of the
flag of the same name; the checkpoint's default lies in the temporary
directory. The last line of standard output is one JSON object: the JAX
script's keys, plus ``device`` and ``card``.

    python3 scripts/torch_novel_view_bench.py               # the card
    python3 scripts/torch_novel_view_bench.py --steps 4500 --opacity-reset 1200 \\
        --bf16-grads                                        # NV run D
    python3 scripts/torch_novel_view_bench.py --device cpu --cap 2000 \\
        --gt 2000 --res 64 --poses 6 --holdout-every 3 --steps 20 --segment 10

``main(argv)`` runs it in-process and returns the JSON object.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_train_bench as tb  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def add_protocol_args(ap) -> None:
    """The flags that fix the GT protocol, shared with
    ``torch_nv_holdout_eval.py``."""
    env = os.environ.get
    ap.add_argument("--cap", type=int, default=int(env("NV_CAP", "1000000")),
                    help="densify capacity (static row count)")
    ap.add_argument("--gt", type=int, default=int(env("NV_GT", "500000")),
                    help="ground-truth splats")
    ap.add_argument("--res", type=int, default=int(env("NV_RES", "512")),
                    help="square view resolution")
    ap.add_argument("--poses", type=int, default=int(env("NV_POSES", "72")))
    ap.add_argument("--holdout-every", type=int,
                    default=int(env("NV_HOLDOUT_EVERY", "9")))
    ap.add_argument("--gt-colors", choices=["random", "correlated"],
                    default=env("NV_GT_COLORS", "random"))
    ap.add_argument("--ckpt", default=env("NV_CKPT", os.path.join(
        tempfile.gettempdir(), "torch_novel_view.ckpt.npz")))
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    default="cpu" if env("NV_CPU") else "cuda",
                    help="run on the CUDA card (default) or on the CPU")


def parse_args(argv=None):
    env = os.environ.get
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_protocol_args(ap)
    ap.add_argument("--steps", type=int, default=int(env("NV_STEPS", "3000")))
    ap.add_argument("--segment", type=int, default=int(env("NV_SEGMENT", "500")),
                    help="steps between checkpoint, resume and holdout scoring")
    # graphdeco's densify threshold: on this scene 2e-4 grows ~212k splats
    ap.add_argument("--grad-threshold", type=float,
                    default=float(env("NV_GRAD_THRESHOLD", "2e-4")))
    ap.add_argument("--opacity-reset", type=int,
                    default=int(env("NV_OPACITY_RESET", "0")),
                    help="opacity reset interval in steps (0: none)")
    ap.add_argument("--grid", default=env("NV_GRID", "novel_view_grid.png"),
                    help="GT | fit PNG over 4 holdout poses")
    ap.add_argument("--bf16-grads", action="store_true",
                    default=env("GS_BWD_SORT", "f32") == "bf16",
                    help="round the field cotangents to bf16 in pairs through "
                    "the record sort's backward (GS_BWD_SORT=bf16)")
    return ap.parse_args(argv)


def make_poses(n: int, w: int, h: int):
    """Two interleaved rings (heights 0.6 / 1.3) of origin-facing cameras."""
    from openglgaussiansplattingrenderer_tpu_torch.camera import Camera

    cams = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        hgt, rad, tilt = (0.6, 3.5, 8.0) if i % 2 == 0 else (1.3, 3.8, 17.0)
        c = Camera(float(rad * np.sin(a)), hgt, float(-rad * np.cos(a)),
                   width=w, height=h)
        c.rotate_right(float(np.degrees(a)))
        c.rotate_down(tilt)
        cams.append(c)
    return cams


def correlated_colors(means: np.ndarray) -> np.ndarray:
    """A smooth low-frequency colour field over the splat means (sums of
    sinusoids), in 0..255: real captures' correlated texture in place of
    the generator's uncorrelated colours."""
    m = np.asarray(means)
    phase = [np.sin(1.3 * m[:, 0] + 0.7 * m[:, 1]),
             np.sin(0.9 * m[:, 1] - 1.1 * m[:, 2] + 2.0),
             np.sin(1.7 * m[:, 2] + 0.5 * m[:, 0] + 4.0)]
    return np.stack([(0.5 + 0.5 * p) * 255.0 for p in phase], axis=1).astype(np.float32)


def protocol(args, dev):
    """(GT scene (numpy), its parameters on ``dev``, all poses, holdout
    indices, render config) of the protocol ``args`` fix."""
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io

    gt = ply_io.make_clustered_scene(args.gt, seed=3, extent=2.0)
    if args.gt_colors == "correlated":
        gt["colors"] = correlated_colors(gt["means"])
        log("GT colors: correlated low-frequency positional field")
    gtp = tb.gt_params(gt, dev)
    cams = make_poses(args.poses, args.res, args.res)
    hold_idx = sorted(set(range(0, args.poses, args.holdout_every)))
    cfg = tb.training_cfg(gtp, cams[0], args.res, args.res, args.cap)
    return gt, gtp, cams, hold_idx, cfg


def holdout_scores(params, cams, targets, cfg, w: int, h: int):
    """Per-pose (PSNR list, SSIM list) of ``params`` against ``targets``.
    SSIM matters on correlated-texture GT: PSNR punishes coherent errors on
    smooth colour fields much harder than speckle."""
    from openglgaussiansplattingrenderer_tpu_torch.train import losses

    ps, ss = [], []
    for c, t in zip(cams, targets):
        pred = tb.render_view(params, c, cfg, w, h, check_overflow=False)
        ps.append(float(losses.psnr(pred, t)))
        ss.append(float(losses.ssim(pred, t)))
    return ps, ss


def main(argv=None) -> dict:
    args = parse_args(argv)

    from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png, to_uint8
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.train import densify, trainer
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        require_device,
    )

    dev = require_device(args.device)
    card = card_line(dev)
    w = h = args.res
    steps, segment = args.steps, args.segment
    log(f"device: {dev} ({card}); CAP={args.cap} GT={args.gt} res={w}x{h} "
        f"poses={args.poses} steps={steps} segment={segment} "
        f"bf16 cotangents={args.bf16_grads}")

    gt, gtp, cams, hold_idx, cfg = protocol(args, dev)
    train_cams = [c for i, c in enumerate(cams) if i not in hold_idx]
    hold_cams = [cams[i] for i in hold_idx]
    log(f"{len(train_cams)} train poses, {len(hold_cams)} holdout poses; render "
        f"capacity {cfg.capacity_records} records")

    t0 = time.time()
    targets = [tb.render_view(gtp, c, cfg, w, h) for c in cams]
    tgt_train = [t for i, t in enumerate(targets) if i not in hold_idx]
    tgt_hold = [targets[i] for i in hold_idx]
    del targets
    log(f"rendered {args.poses} GT views in {time.time() - t0:.1f}s")

    init = tb.sfm_init(gt["means"], args.cap)
    dc = densify.DensifyConfig(
        capacity=args.cap, scene_extent=2.0, start_step=100,
        stop_step=int(steps * 0.8), interval=100,
        grad_threshold=args.grad_threshold,
        opacity_reset_interval=args.opacity_reset)
    tc_full = trainer.TrainConfig(steps=steps, lr_means=2e-4, lr_means_final=2e-6,
                                  lr_means_decay_steps=steps)

    pack = kr.BWD_COT_PACK
    if args.bf16_grads:
        kr.BWD_COT_PACK = "bf16"
    curve = []
    fitted, resume = None, None
    t_train0 = time.time()
    try:
        for boundary in range(segment, steps + 1, segment):
            tc = dataclasses.replace(tc_full, steps=boundary)
            fitted, _, hist = densify.fit_scene_adaptive(
                init, tgt_train, train_cams, cfg, dc, tc=tc, width=w, height=h,
                log_every=100, verbose=True, save_every=segment,
                checkpoint_path=args.ckpt, resume=resume, device=dev)
            resume = args.ckpt
            hp, hs = holdout_scores(fitted, hold_cams, tgt_hold, cfg, w, h)
            train_psnr = hist[-1]["psnr"] if hist else float("nan")
            curve.append({"step": boundary,
                          "train_psnr": train_psnr,
                          "holdout_psnr_mean": float(np.mean(hp)),
                          "holdout_psnr_min": float(np.min(hp)),
                          "holdout_ssim_mean": float(np.mean(hs)),
                          "holdout_ssim_min": float(np.min(hs)),
                          "alive": hist[-1]["alive"] if hist else None,
                          "wall_s": time.time() - t_train0})
            log(f"segment to {boundary}: train {train_psnr:.2f} dB, holdout "
                f"{np.mean(hp):.2f} dB (min {np.min(hp):.2f}), ssim {np.mean(hs):.4f}")
    finally:
        kr.BWD_COT_PACK = pack

    rows = []
    for c, t in list(zip(hold_cams, tgt_hold))[:4]:
        pred = tb.render_view(fitted, c, cfg, w, h, check_overflow=False)
        rows.append(np.concatenate([t.cpu().numpy(), pred.cpu().numpy()], axis=1))
    save_png(args.grid, to_uint8(np.concatenate(rows, axis=0)))
    log(f"wrote {args.grid}")

    final = curve[-1]
    out = {
        "cap": args.cap, "gt_splats": args.gt, "res": f"{w}x{h}",
        "train_views": len(train_cams), "holdout_views": len(hold_cams),
        "steps": steps,
        "final_train_psnr": final["train_psnr"],
        "final_holdout_psnr": final["holdout_psnr_mean"],
        "final_holdout_ssim": final["holdout_ssim_mean"],
        "generalisation_gap_db": final["train_psnr"] - final["holdout_psnr_mean"],
        "final_alive": final["alive"],
        "total_train_s": final["wall_s"],
        "curve": curve,
        "device": str(dev), "card": card,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
