#!/usr/bin/env python3
"""Training CLI of the PyTorch/CUDA port: fit a splat scene to target views.

The port's counterpart of ``scripts/train_cli.py``. The scene is one of:

- a 3DGS PLY: target views are rendered on an orbit around it and a subset
  of its splats (``--init subset``, or with perturbed appearance, ``noise``)
  is fitted to them;
- a NeRF-style ``transforms.json``: fit from its images, from a random
  initial cloud;
- a COLMAP workspace or model directory: fit from its images, initialised
  from the SfM point cloud.

``--densify`` grows and prunes the set with adaptive density control
(``train.densify.fit_scene_adaptive``) under a static ``--capacity``.
``--data-parallel NDEV`` trains a batch of NDEV views a step with the
parameters replicated (``parallel.data_parallel.fit_scene_dp``);
``--mesh2d DVxDS`` trains on a DV x DS (view x splat) mesh
(``parallel.mesh2d.fit_scene_2d``). Both compose with ``--densify``; on
``--device cuda`` their meshes are over distinct cards, on ``--device
cpu`` over repeated CPU devices.
Writes the fitted scene as a PLY, a target | fit comparison PNG of view 0
and a JSON history (loss, PSNR, live splats). Training runs on the CUDA
card (``--device cuda``, the default) with the port's kernels, or on the
CPU with their plain versions (``--device cpu``); ``--no-pallas`` selects
the oracle pipeline instead of the kernels.

Examples:
  python3 scripts/torch_train_cli.py scene.ply -o fitted.ply --steps 300
  python3 scripts/torch_train_cli.py scene.ply --densify --capacity 2000
  python3 scripts/torch_train_cli.py scene.ply --device cpu --width 64 \\
      --height 64 --steps 20 --densify
  python3 scripts/torch_train_cli.py scene.ply --mesh2d 2x2 --densify

``main(argv)`` runs it in-process and returns the exit code.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene", help="target 3DGS PLY file, a NeRF-style "
                    "transforms.json posed-image dataset (fit from images, "
                    "random init), or a COLMAP workspace/model directory "
                    "(fit from images, SfM point-cloud init)")
    ap.add_argument("--init-extent", type=float, default=2.0,
                    help="dataset mode: radius of the random init cloud")
    ap.add_argument("-o", "--output", default="fitted.ply")
    ap.add_argument("--out-png", default="fit_compare.png",
                    help="side-by-side target | fitted render of view 0")
    ap.add_argument("--history", default="fit_history.json")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--views", type=int, default=6,
                    help="number of orbit target views")
    ap.add_argument("--orbit-radius", type=float, default=5.0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--init", choices=["subset", "noise"], default="subset",
                    help="fit from a random subset of the target splats, or "
                         "from subset positions with perturbed appearance")
    ap.add_argument("--init-count", type=int, default=0,
                    help="initial splat count (0 = target count / 4)")
    ap.add_argument("--densify", action="store_true",
                    help="enable adaptive density control")
    ap.add_argument("--data-parallel", type=int, default=0, metavar="NDEV",
                    help="view-parallel training over NDEV devices (one view "
                    "per device per step; params replicated, grads pmean-"
                    "synced). 0 = off; requires NDEV <= device count; "
                    "composes with --densify")
    ap.add_argument("--mesh2d", default="", metavar="DVxDS",
                    help="2-D mesh training, e.g. 2x4: DV view rows x DS "
                    "splat shards (params splat-sharded, batch of DV views "
                    "per step). Mutually exclusive with --data-parallel; "
                    "composes with --densify")
    ap.add_argument("--capacity", type=int, default=0,
                    help="densify capacity (0 = 4x init count)")
    ap.add_argument("--densify-interval", type=int, default=100)
    ap.add_argument("--densify-start", type=int, default=50,
                    help="first step eligible for densification")
    ap.add_argument("--grad-threshold", type=float, default=2e-4)
    ap.add_argument("--opacity-reset-interval", type=int, default=0,
                    help="3DGS periodic opacity reset every N steps "
                         "(0 = off; the paper uses 3000)")
    ap.add_argument("--lambda-dssim", type=float, default=0.2)
    ap.add_argument("--antialiased", action="store_true",
                    help="train with opacity compensation (anti-aliased "
                         "mode); render the result with --antialiased too")
    ap.add_argument("--lr-means-final", type=float, default=0.0,
                    help="enable the 3DGS exponential position-LR decay "
                         "down to this value (0 = constant LR)")
    ap.add_argument("--lr-decay-steps", type=int, default=0,
                    help="position-LR decay horizon (default: --steps)")
    ap.add_argument("--lr-scale", type=float, default=1.0,
                    help="multiplier on all default learning rates")
    ap.add_argument("--sh-degree", type=int, default=0,
                    help="render/train view-dependent SH up to this degree")
    ap.add_argument("--tile-px", type=int, default=32)
    ap.add_argument("--capacity-factor", type=float, default=8.0)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--no-pallas", action="store_true",
                    help="train through the oracle pipeline (plain torch, "
                    "no kernel) instead of the kernels")
    ap.add_argument("--bf16-grads", action="store_true",
                    help="round the field cotangents to bf16 in pairs through "
                    "the record sort's backward (GS_BWD_SORT=bf16): not "
                    "bit-equal to f32")
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="write a full-state checkpoint (params + optimizer "
                    "+ densify state) every N steps; 0 = off")
    ap.add_argument("--ckpt", default="", metavar="PATH",
                    help="checkpoint path (default: <output>.ckpt.npz)")
    ap.add_argument("--resume", default="", metavar="PATH",
                    help="resume training from a checkpoint written by "
                    "--save-every; replays the uninterrupted run exactly")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="train on the CUDA card (default) or on the CPU")
    return ap.parse_args(argv)


def load_scene(args, cfg, device, rng):
    """(cameras, targets, start params, extent) for the scene argument, or
    None after printing why it cannot be used."""
    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.render import render_stats
    from openglgaussiansplattingrenderer_tpu_torch.viewer.offline import orbit_cameras

    if os.path.isdir(args.scene):
        # COLMAP workspace: <dir>/sparse/0 model + <dir>/images, or the
        # model directory itself; init from the SfM point cloud (3DGS
        # sec. 4). Pass --width/--height matching the capture resolution.
        from openglgaussiansplattingrenderer_tpu_torch.io import colmap as colmap_io

        sparse = args.scene
        if not any(os.path.exists(os.path.join(sparse, "cameras" + e))
                   for e in (".bin", ".txt")):
            sparse = os.path.join(args.scene, "sparse", "0")
        cams, images, points = colmap_io.load_colmap(sparse)
        pairs = [(c, im) for c, im in zip(cams, images) if im is not None]
        if not pairs:
            print("FATAL: COLMAP model has no readable images", file=sys.stderr)
            return None
        cams = [c for c, _ in pairs]
        targets = [np.asarray(im, np.float32) for _, im in pairs]
        start = colmap_io.init_params_from_points(
            points["xyz"], points["rgb"], max_points=args.init_count or None,
            seed=args.seed)
        if args.sh_degree > 0:
            start["sh_rest"] = np.zeros((len(start["means"]), 45), np.float32)
        extent = float(np.abs(start["means"] - start["means"].mean(0)).max()) or 1.0
        print(f"COLMAP: {len(cams)} posed images, {len(start['means'])} SfM "
              "seed points", file=sys.stderr)
    elif args.scene.endswith(".json"):
        # posed-image dataset: fit from the images, random init cloud
        from openglgaussiansplattingrenderer_tpu_torch.io import dataset as ds_io

        cams, images = ds_io.load_transforms(args.scene)
        pairs = [(c, im) for c, im in zip(cams, images) if im is not None]
        if not pairs:
            print("FATAL: dataset has no readable images", file=sys.stderr)
            return None
        cams = [c for c, _ in pairs]
        targets = [np.asarray(im, np.float32) for _, im in pairs]
        extent = args.init_extent
        n0 = args.init_count or 512
        start = {
            "means": rng.normal(0.0, extent / 2.0, (n0, 3)).astype(np.float32),
            "scales": np.full((n0, 3), extent / 30.0, np.float32),
            "quats": np.tile(np.array([1.0, 0, 0, 0], np.float32), (n0, 1)),
            "opacities": np.full(n0, 0.3, np.float32),
            "colors": np.full((n0, 3), 128.0, np.float32),
        }
        if args.sh_degree > 0:
            start["sh_rest"] = np.zeros((n0, 45), np.float32)
        print(f"dataset: {len(cams)} posed images, init {n0} random splats",
              file=sys.stderr)
    else:
        scene = ply_io.load_splats(args.scene)
        keep_sh = args.sh_degree > 0
        scene = {k: v for k, v in scene.items() if keep_sh or k != "sh_rest"}
        n = int(scene["means"].shape[0])
        center = scene["means"].mean(axis=0)
        extent = float(np.abs(scene["means"] - center).max())
        print(f"target: {n} splats, extent {extent:.2f}", file=sys.stderr)

        cams = orbit_cameras(center, args.orbit_radius, args.views,
                             width=args.width, height=args.height)
        target_params = params_from_numpy(scene, device)
        targets = []
        with torch.no_grad():
            for cam in cams:
                img, stats = render_stats(target_params, cam, cfg)
                if int(stats["overflow"]) > 0:
                    print(f"WARNING: target render overflow "
                          f"{int(stats['overflow'])} -- raise --capacity-factor",
                          file=sys.stderr)
                targets.append(img[..., :3].cpu().numpy())
        del target_params

        n0 = args.init_count or max(8, n // 4)
        idx = rng.choice(n, size=min(n0, n), replace=False)
        start = {k: np.asarray(v)[idx] for k, v in scene.items()}
        if args.init == "noise":
            start["colors"] = np.clip(
                start["colors"] + rng.normal(0, 40, start["colors"].shape),
                0, 255).astype(np.float32)
            start["opacities"] = np.full(len(idx), 0.5, np.float32)
    return cams, targets, start, extent


def parse_mesh2d(text):
    """``DVxDS`` -> (dv, ds), or None when it does not parse."""
    try:
        dv, ds = (int(x) for x in text.lower().split("x"))
    except ValueError:
        return None
    return (dv, ds) if dv >= 1 and ds >= 1 else None


def mesh_devices(n, device):
    """``n`` devices of the kind ``device`` names: distinct cards for
    cuda, the CPU repeated for cpu; None when fewer cards exist."""
    import torch

    if device.type == "cpu":
        return ["cpu"] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"cuda:{i}" for i in range(n)] if n <= have else None


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mesh2d and args.data_parallel:
        print("FATAL: --mesh2d is mutually exclusive with --data-parallel",
              file=sys.stderr)
        return 1
    mesh2d_dims = parse_mesh2d(args.mesh2d) if args.mesh2d else None
    if args.mesh2d and mesh2d_dims is None:
        print(f"FATAL: --mesh2d wants DVxDS with positive dims (e.g. 2x4), got "
              f"{args.mesh2d!r}", file=sys.stderr)
        return 1

    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.render import (
        render_arrays,
        render_stats,
    )
    from openglgaussiansplattingrenderer_tpu_torch.train import (
        DensifyConfig,
        TrainConfig,
        fit_scene,
        fit_scene_adaptive,
        losses,
    )
    from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn

    device = torch.device(args.device)
    need = (mesh2d_dims[0] * mesh2d_dims[1] if mesh2d_dims else args.data_parallel)
    mesh_devs = mesh_devices(need, device) if need else None
    if need and mesh_devs is None:
        flag = f"--mesh2d {args.mesh2d}" if mesh2d_dims else f"--data-parallel {need}"
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"FATAL: {flag} needs {need} CUDA devices, have {have}", file=sys.stderr)
        return 1
    cfg = RenderConfig.for_resolution(
        args.width, args.height, tile_px=args.tile_px,
        use_pallas=not args.no_pallas, chunk=args.chunk,
        dup_capacity_factor=args.capacity_factor,
        sh_degree=args.sh_degree, antialiased=args.antialiased)

    rng = np.random.default_rng(args.seed)
    loaded = load_scene(args, cfg, device, rng)
    if loaded is None:
        return 1
    cams, targets, start, extent = loaded

    tc = TrainConfig(
        steps=args.steps, lambda_dssim=args.lambda_dssim,
        lr_means=1.6e-4 * args.lr_scale, lr_scales=5e-3 * args.lr_scale,
        lr_quats=1e-3 * args.lr_scale, lr_opacities=5e-2 * args.lr_scale,
        lr_colors=2.5e-1 * args.lr_scale,
        lr_means_final=(args.lr_means_final * args.lr_scale
                        if args.lr_means_final > 0 else None),
        lr_means_decay_steps=args.lr_decay_steps or None)
    ckpt = args.ckpt or args.output + ".ckpt.npz"

    # the cotangent mode is read at each backward: set it for this run only
    pack = kr.BWD_COT_PACK
    if args.bf16_grads:
        kr.BWD_COT_PACK = "bf16"
    try:
        dc = None
        if args.densify:
            capacity = args.capacity or 4 * start["means"].shape[0]
            dc = DensifyConfig(capacity=capacity,
                               grad_threshold=args.grad_threshold,
                               scene_extent=extent,
                               interval=args.densify_interval,
                               start_step=args.densify_start,
                               stop_step=int(args.steps * 0.8),
                               opacity_reset_interval=args.opacity_reset_interval)
        common = dict(log_every=args.log_every, save_every=args.save_every,
                      checkpoint_path=ckpt, resume=args.resume or None)
        if mesh2d_dims or args.data_parallel:
            par = dict(common, width=args.width, height=args.height, dc=dc,
                       seed=args.seed)
            if mesh2d_dims:
                from openglgaussiansplattingrenderer_tpu_torch.parallel import mesh2d

                out = mesh2d.fit_scene_2d(
                    start, targets, cams, cfg, tc,
                    mesh=mesh2d.make_mesh2d(*mesh2d_dims, devices=mesh_devs), **par)
            else:
                from openglgaussiansplattingrenderer_tpu_torch.parallel import (
                    data_parallel as dp,
                )

                out = dp.fit_scene_dp(start, targets, cams, cfg, tc,
                                      mesh=dp.make_mesh(devices=mesh_devs), **par)
            fitted, hist = out[0], out[-1]
            alive = out[1] if dc is not None else None
        elif args.densify:
            fitted, alive, hist = fit_scene_adaptive(
                start, targets, cams, cfg, dc, tc=tc, seed=args.seed, device=device,
                **common)
        else:
            fitted, hist = fit_scene(start, targets, cams, cfg, tc, device=device,
                                     **common)
        if dc is not None:
            out_params = dn.compact_params(fitted, alive)
        else:
            out_params = {k: v.detach().cpu().numpy() for k, v in fitted.items()}
    finally:
        kr.BWD_COT_PACK = pack

    ply_io.save_ply(args.output, out_params["means"], out_params["quats"],
                    out_params["scales"], out_params["opacities"],
                    out_params["colors"], sh_rest=out_params.get("sh_rest"))
    print(f"wrote {args.output} ({out_params['means'].shape[0]} splats)",
          file=sys.stderr)

    with torch.no_grad():
        if isinstance(cams[0], dict):
            b = cams[0]
            img, _ = render_arrays(fitted, b["view"], b["vp"], b["focal_x"],
                                   b["focal_y"], b["tan_fovx"], b["tan_fovy"],
                                   int(b["width"]), int(b["height"]), cfg)
        else:
            img, _ = render_stats(fitted, cams[0], cfg)
        fit0 = img[..., :3].cpu().numpy()
    psnr = float(losses.psnr(torch.from_numpy(fit0), torch.from_numpy(targets[0])))
    save_png(args.out_png, np.concatenate([targets[0], fit0], axis=1))
    with open(args.history, "w") as f:
        json.dump({"history": hist, "final_psnr_view0": psnr,
                   "splats": int(out_params["means"].shape[0])}, f, indent=1)
    print(f"view-0 PSNR {psnr:.2f} dB; wrote {args.out_png}, {args.history}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
