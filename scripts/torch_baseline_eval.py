#!/usr/bin/env python3
"""The BASELINE.md measurement configs on the PyTorch/CUDA port.

The port's counterpart of ``scripts/baseline_eval.py``:

1. one Gaussian at 256x256 against the numpy golden renderer
   (``golden.golden_render``), within the reference's own CPU/GPU
   tolerance of 1e-2: the reference's ``testSingleItem.ply`` where
   ``--reference-ply`` names a readable copy, else the same Gaussian built
   in (``io.ply.single_splat_scene``); ``src`` says which;
2. 10,000 synthetic splats at 512x512, forward;
3. 100,000 synthetic splats at 512x512, forward + backward of the L2 loss
   against black, and the gradient of each parameter tensor against a
   central finite difference along that gradient's direction (eps sized so
   the loss moves by ~1e-3, far above float32 resolution).

Frame times: 10 calls (config 3: 5), CUDA events on the card. The JAX
script writes ``RESULTS.md``; this one writes nothing and prints one JSON
object as the last line of standard output, each config's numbers under
its name, plus ``device`` and ``card``.

    python3 scripts/torch_baseline_eval.py                   # the card
    python3 scripts/torch_baseline_eval.py --device cpu --configs 1

``main(argv)`` runs it in-process and returns the JSON object.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FD_KEYS = ("colors", "means", "scales", "opacities", "quats")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", default="1,2,3",
                    help="comma-separated configs to run (default all three)")
    ap.add_argument("--reference-ply", default="",
                    help="the reference's testSingleItem.ply for config 1")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="render on the CUDA card (default) or on the CPU")
    args = ap.parse_args(argv)
    args.configs = sorted({int(c) for c in args.configs.split(",")})
    if not set(args.configs) <= {1, 2, 3}:
        ap.error(f"--configs takes 1, 2 and 3, got {args.configs}")
    return args


def single_splat(reference_ply: str):
    """(scene, src): the reference's fixture where it reads, else the
    built-in copy of it."""
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io

    scene = ply_io.single_splat_scene()
    if reference_ply:
        try:
            ref = ply_io.activate(ply_io.load_ply(reference_ply))
        except (OSError, ValueError, KeyError) as e:
            log(f"config 1: {reference_ply} unreadable ({e}); built-in fixture")
        else:
            scene.update({k: ref[k] for k in
                          ("means", "scales", "quats", "opacities", "colors")})
            return scene, "reference testSingleItem.ply"
    return scene, "built-in fixture"


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from openglgaussiansplattingrenderer_tpu_torch import golden
    from openglgaussiansplattingrenderer_tpu_torch.camera import Camera
    from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        median_ms,
        require_device,
    )

    dev = require_device(args.device)
    card = card_line(dev)
    log(f"device: {dev} ({card})")
    out = {}

    def frame_of(scene, cam, cfg):
        """(forward thunk, params, camera args) of a scene and camera."""
        a = camera_args(cam)
        view = torch.as_tensor(a["view"], device=dev)
        vp = torch.as_tensor(a["vp"], device=dev)
        cam_f = (a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])
        params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"},
                                   dev)

        def fwd(p=params):
            return render_arrays(p, view, vp, *cam_f, cam.width, cam.height, cfg)
        return fwd, params, a

    if 1 in args.configs:
        scene, src = single_splat(args.reference_ply)
        cam = Camera(0.0, 0.0, -3.0, width=256, height=256)
        cfg1 = RenderConfig(use_pallas=True, chunk=256, dup_capacity_factor=256.0)
        fwd, _, a = frame_of(scene, cam, cfg1)
        with torch.no_grad():
            ms, (img, _) = median_ms(fwd, dev, 10, 1)
        gold, _ = golden.golden_render(
            {k: scene[k] for k in ("means", "scales", "quats", "opacities", "colors")},
            a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], 256, 256, cfg1)
        diff = float(np.abs(img.cpu().numpy() - gold).max())
        out["config1"] = {"src": src, "max_abs_diff_vs_golden": diff, "tolerance": 1e-2,
                          "frame_ms": ms}
        log(f"config1 ({src}): diff {diff:.3e}, {ms:.3f} ms")

    if 2 in args.configs:
        scene = ply_io.make_synthetic_scene(10_000, seed=7, extent=2.5)
        cam = Camera(0.0, 0.0, -6.0, width=512, height=512)
        cfg2 = RenderConfig(use_pallas=True, chunk=256, dup_capacity_factor=16.0)
        fwd, _, _ = frame_of(scene, cam, cfg2)
        with torch.no_grad():
            ms, (_, stats) = median_ms(fwd, dev, 10, 1)
        out["config2"] = {"splats": 10_000, "frame_ms": ms, "fps": 1000 / ms,
                          "records": int(stats["num_records"]),
                          "overflow": int(stats["overflow"])}
        log(f"config2: {ms:.3f} ms/frame")

    if 3 in args.configs:
        scene = ply_io.make_synthetic_scene(100_000, seed=11, extent=3.0,
                                            log_scale_range=(-5.0, -3.0))
        cam = Camera(0.0, 0.0, -8.0, width=512, height=512)
        cfg3 = RenderConfig.for_resolution(512, 512, tile_px=32, use_pallas=True,
                                           chunk=256, dup_capacity_factor=12.0)
        fwd, params, _ = frame_of(scene, cam, cfg3)

        def loss_of(p):
            img, _ = fwd(p)
            return (img[..., :3] ** 2).mean()

        def value_and_grad():
            q = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = loss_of(q)
            return loss.detach(), dict(zip(q, torch.autograd.grad(loss, list(q.values()))))

        fb_ms, (_, grads) = median_ms(value_and_grad, dev, 5, 1)
        rows = []
        with torch.no_grad():
            for key in FD_KEYS:
                g = grads[key].double()
                gn = float(torch.linalg.vector_norm(g))
                d = (g / max(gn, 1e-30)).float()
                eps = float(np.clip(5e-4 / max(gn, 1e-12), 1e-4, 50.0))
                lp = float(loss_of({**params, key: params[key] + eps * d}))
                lm = float(loss_of({**params, key: params[key] - eps * d}))
                fd = (lp - lm) / (2 * eps)
                rel = abs(fd - gn) / max(abs(gn), abs(fd), 1e-12)
                rows.append({"param": key, "autodiff": gn, "finite_diff": fd,
                             "eps": eps, "rel_err": rel})
                log(f"config3 fd {key}: ad={gn:.3e} fd={fd:.3e} eps={eps:.2e} "
                    f"rel={rel:.3f}")
        out["config3"] = {"splats": 100_000, "fwdbwd_ms": fb_ms,
                          "msplat_per_s": 100_000 / fb_ms * 1000 / 1e6,
                          "fd": rows, "worst_rel_err": max(r["rel_err"] for r in rows)}

    out.update(device=str(dev), card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
