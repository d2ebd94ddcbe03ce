#!/usr/bin/env python3
"""Score a novel-view checkpoint of the PyTorch/CUDA port on its holdout
poses (PSNR and SSIM, pose by pose).

The port's counterpart of ``scripts/nv_holdout_eval.py``. It rebuilds the
GT protocol of ``scripts/torch_novel_view_bench.py`` (the same seeds, pose
rings and holdout interleave: its flags ``--cap``, ``--gt``, ``--res``,
``--poses``, ``--holdout-every``, ``--gt-colors``, ``--ckpt``,
``--device``, and the JAX script's environment variables as their
defaults), loads the checkpoint (``trainer.load_checkpoint_full``,
``trainer.params_from_raw``) and renders each holdout pose against its GT.
The last line of standard output is one JSON object: the JAX script's
keys, plus ``device`` and ``card``.

    python3 scripts/torch_nv_holdout_eval.py --ckpt run_d.ckpt.npz
    python3 scripts/torch_nv_holdout_eval.py --device cpu --cap 2000 \\
        --gt 2000 --res 64 --poses 6 --holdout-every 3 --ckpt nv.ckpt.npz

``main(argv)`` runs it in-process and returns the JSON object.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_novel_view_bench as nv  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    nv.add_protocol_args(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from openglgaussiansplattingrenderer_tpu_torch.train import trainer
    from openglgaussiansplattingrenderer_tpu_torch.utils.timing import (
        card_line,
        require_device,
    )

    dev = require_device(args.device)
    card = card_line(dev)
    w = h = args.res
    log(f"device: {dev} ({card}); ckpt={args.ckpt}")

    _, gtp, cams, hold_idx, cfg = nv.protocol(args, dev)
    raw, step, extras = trainer.load_checkpoint_full(args.ckpt)
    with torch.no_grad():
        params = trainer.params_from_raw(
            {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in raw.items()})
    alive = int(np.sum(extras["alive"])) if "alive" in extras else None
    log(f"checkpoint step {step}, alive {alive}")

    rows = []
    for i in hold_idx:
        target = nv.tb.render_view(gtp, cams[i], cfg, w, h, check_overflow=False)
        ps, ss = nv.holdout_scores(params, [cams[i]], [target], cfg, w, h)
        rows.append({"pose": i, "psnr": ps[0], "ssim": ss[0]})
        log(rows[-1])

    out = {
        "ckpt": args.ckpt, "step": step, "alive": alive,
        "holdout_psnr_mean": float(np.mean([r["psnr"] for r in rows])),
        "holdout_ssim_mean": float(np.mean([r["ssim"] for r in rows])),
        "per_pose": rows,
        "device": str(dev), "card": card,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
