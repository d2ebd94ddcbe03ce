#!/usr/bin/env python3
"""Render CLI of the PyTorch/CUDA port: the reference app (``main.cpp``) as a
headless command.

The port's counterpart of ``scripts/render_cli.py``. Where the reference
hard-codes its scene path, camera pose and resolution in source ("currently
needs recompiled to change the file", README.md:10-12), everything here is
a flag with the reference's value as the default. Frames render on the CUDA
card with the port's kernels (``--device cuda``, the default) or on the CPU
with their plain versions (``--device cpu``); ``--no-pallas`` selects the
oracle pipeline (plain PyTorch, no kernel) and ``--golden`` the numpy
golden render.

Examples:
  python3 scripts/torch_render_cli.py scene.ply -o out.png
  python3 scripts/torch_render_cli.py scene.ply --orbit 24 --out-dir frames/
  python3 scripts/torch_render_cli.py scene.ply --golden -o gold.png

``main(argv)`` runs it in-process and returns the exit code.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene", help="3DGS PLY file")
    ap.add_argument("-o", "--output", default="render.png")
    ap.add_argument("--width", type=int, default=1024)   # Camera.h:55
    ap.add_argument("--height", type=int, default=512)   # Camera.h:62
    ap.add_argument("--pos", type=float, nargs=3, default=[5.0, 0.5, -4.0],
                    help="camera position (reference pose, main.cpp:40)")
    ap.add_argument("--rot", type=float, nargs=3, default=[-20.0, 40.0, 0.0],
                    help="camera euler rotation deg (main.cpp:42-44)")
    ap.add_argument("--fovy", type=float, default=60.0)
    ap.add_argument("--tile-px", type=int, default=0,
                    help="tile pixel size (0 = reference 16x16 grid)")
    ap.add_argument("--capacity-factor", type=float, default=8.0)
    ap.add_argument("--autotune", action="store_true",
                    help="pin record capacity to the measured count for "
                         "the initial camera (render.autotune_capacity)")
    ap.add_argument("--depth-key", default="pair",
                    choices=["pair", "packed", "reference"],
                    help="record sort key: exact f32 pair (default), packed "
                         "u32 tile|22-bit depth, or the reference's lossy "
                         "float key")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--q16", action="store_true",
                    help="q16 inference precision: record-sort payloads "
                         "packed to 5 u32 words (config.sort_payload). "
                         "Implies --depth-key packed")
    ap.add_argument("--no-pallas", action="store_true",
                    help="use the oracle pipeline (plain PyTorch, no kernel)")
    ap.add_argument("--golden", action="store_true",
                    help="render with the numpy golden pipeline (cpuRender)")
    ap.add_argument("--antialiased", action="store_true",
                    help="opacity-compensated (anti-aliased) mode for scenes "
                         "trained with dilation compensation")
    ap.add_argument("--depth", action="store_true",
                    help="render an expected-depth map (normalized to [0,1] "
                         "over covered pixels) instead of RGB")
    ap.add_argument("--orbit", type=int, default=0,
                    help="render an N-frame orbit instead of one frame")
    ap.add_argument("--out-dir", default="frames")
    ap.add_argument("--orbit-radius", type=float, default=5.0)
    ap.add_argument("--stats", action="store_true", help="print frame stats")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="render on the CUDA card (default) or on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig, Splats
    from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png
    from openglgaussiansplattingrenderer_tpu_torch.render import camera_args
    from openglgaussiansplattingrenderer_tpu_torch.viewer import offline

    if args.device == "cuda" and not torch.cuda.is_available():
        print("FATAL: no CUDA device (pass --device cpu to render on the CPU)",
              file=sys.stderr)
        return 1
    kw = dict(use_pallas=not args.no_pallas,
              dup_capacity_factor=args.capacity_factor, chunk=args.chunk,
              antialiased=args.antialiased, depth_key=args.depth_key)
    if args.q16:
        kw.update(sort_payload="q16", depth_key="packed")
    if args.tile_px > 0:
        cfg = RenderConfig.for_resolution(args.width, args.height,
                                          tile_px=args.tile_px, **kw)
    else:
        cfg = RenderConfig(**kw)

    splats = Splats(args.scene, args.width, args.height, cfg=cfg,
                    device=args.device)
    print(f"loaded {splats.num_splats} splats from {args.scene}")

    cam = Camera(*args.pos, width=args.width, height=args.height,
                 fovy=args.fovy)
    cam.set_rotation(*args.rot)

    if args.autotune:
        splats.autotune_capacity(cam)
        cfg = splats.cfg
        print(f"autotuned capacity: {cfg.capacity_records} records")

    if args.orbit > 0:
        summary = offline.render_orbit(
            splats.scene, args.out_dir, radius=args.orbit_radius,
            num_frames=args.orbit, cfg=cfg, width=args.width,
            height=args.height, device=args.device)
        print("orbit:", summary)
        return 0

    if args.depth:
        depth, alpha = splats.render_depth_camera(cam)
        covered = alpha > 1e-3
        if covered.any():
            lo, hi = depth[covered].min(), depth[covered].max()
            depth = np.where(covered, (depth - lo) / max(hi - lo, 1e-12), 0.0)
        save_png(args.output, np.repeat(depth[..., None], 3, axis=-1)
                 .astype(np.float32))
    elif args.golden:
        a = camera_args(cam)
        splats.cpu_render(a["view"], args.width, args.height, a["focal_x"],
                          a["focal_y"], a["tan_fovx"], a["tan_fovy"], a["vp"],
                          save_path=args.output)
    else:
        splats.render_camera(cam)
        splats.display(args.output)
    print(f"wrote {args.output}")
    if args.stats and splats.last_stats:
        for k, v in sorted(splats.last_stats.items()):
            print(f"  {k}: {np.asarray(v).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
