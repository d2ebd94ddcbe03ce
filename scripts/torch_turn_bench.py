#!/usr/bin/env python3
"""End-to-end times of the port's default frame, for comparing two
checkouts on one card in turn.

    python3 scripts/torch_turn_bench.py                      # this checkout
    python3 scripts/torch_turn_bench.py --root build/parent  # another one's package

Imports ``openglgaussiansplattingrenderer_tpu_torch`` from ``--root`` (a
checkout's root; default this one), so that one call can time a parent
and a change as parent, change, change, parent. On ``chip_smoke.py``'s
scenes (the uniform and the clustered flagship, 3,616,103 splats at
1024x512; 1,000,000 splats at 1920x1080), capacity autotuned, default
``depth_key="pair"``, it times:

- the frame (``render_arrays`` under ``torch.no_grad()``): CUDA events
  around each call, the median of ``--reps`` after two warm-up calls; the
  host's time to return from the call, the device idle before it (the
  median of ``--reps``: where it is near the events' time, the host sets
  the pace); and the device time alone: the sum of one call's kernel and
  memset records (torch.profiler), the median of three profiled calls;
- the forward + backward of ``mean(img[..., :3] ** 2)``, the same way;
- on the uniform flagship, the train step (``make_train_step``, L1 + 0.2
  D-SSIM, with the densification statistic): host clock to a sync, the
  median of ``--reps`` steps; CUDA events around a step; its device time
  alone and the names that take most of it (``step_top``); and the step
  split by events the host records as it reaches each part
  (``train_step_split``: render forward, loss forward, loss backward, render
  backward, Adam, the rest), the median of ``--reps`` steps each; and
  the loss's two kernels alone on the step's images (``loss_kernels``:
  device ms, events ms, host us), and Adam's wrapper alone on the step's
  state (``adam``: the same three).

Prints the card and its power limit, a JSON line a scene, then one JSON
object last. Needs a card: without CUDA it exits with "no CUDA device".
"""

from __future__ import annotations

import argparse
import json
import subprocess
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SCENES = {
    # name: (splats, width, height, chunk, scene maker's name and keywords)
    "uniform": (3_616_103, 1024, 512, 256, "make_synthetic_scene",
                dict(seed=99, extent=3.0, log_scale_range=(-5.8, -3.6))),
    "clustered": (3_616_103, 1024, 512, 256, "make_clustered_scene",
                  dict(seed=7, extent=3.0)),
    "1080p": (1_000_000, 1920, 1080, 128, "make_synthetic_scene",
              dict(seed=42, extent=3.0, log_scale_range=(-5.5, -3.2))),
}


def events_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls of fn between CUDA events, after two."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls of fn on the host's clock until the call
    returns, the device synchronised before each call and not after."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, runs: int = 3):
    """Median over ``runs`` profiled calls of the sum of one call's device
    records (kernels and memsets), in ms; None where none was seen."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    sums = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us:
            sums.append(us / 1e3)
    return statistics.median(sums) if sums else None


def device_top(fn, top: int = 10):
    """What one call of ``fn`` runs on the device, from torch.profiler's
    kernel and memset records of one profiled call (after a warm-up call):
    (device ms in all, records, [(name, ms, count)] of the ``top`` names by
    time). The profiler at times loses a record, so the sum is a floor.
    None where it held no device record."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms, count = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name[:70]] += e.time_range.elapsed_us() / 1e3
            count[e.name[:70]] += 1
    if not ms:
        return None
    ranked = sorted(ms, key=ms.get, reverse=True)[:top]
    return sum(ms.values()), sum(count.values()), [(k, ms[k], count[k]) for k in ranked]


def loss_kernels(render_arrays, render_args, target, lam, reps: int) -> dict:
    """The loss's forward and backward wrappers (``ssim_loss.gs_loss_fwd``,
    ``gs_loss_bwd`` of the package timed) on the noisy start's rendered
    RGB, read in place, against the clean frame's: device ms, events ms
    and host us (the call's return, the device idle before it), each as
    ``device_ms``, ``events_ms`` and ``host_ms`` take them."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl

    with torch.no_grad():
        pred = render_arrays(*render_args)[0][..., :3]
    one = torch.ones((), device=pred.device)
    _, parts = kl.gs_loss_fwd(pred, target, lam)
    calls = {"forward": lambda: kl.gs_loss_fwd(pred, target, lam),
             "backward": lambda: kl.gs_loss_bwd(pred, target, parts, one, lam)}
    return {name: {"device_ms": device_ms(fn), "events_ms": events_ms(fn, reps),
                   "host_us": host_ms(fn, reps) * 1e3} for name, fn in calls.items()}


def adam_kernel(step, state, reps: int) -> dict:
    """Adam's wrapper through the train step's optimizer (``Optimizer.update``
    of the package timed) on the step's raw tensors and moments, gradients
    drawn from a seed, under ``torch.no_grad()`` as the step calls it:
    device ms, events ms and host us (the call's return, the device idle
    before it), each as ``device_ms``, ``events_ms`` and ``host_ms`` take
    them."""
    import torch

    dev = next(iter(state.raw.values())).device
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-3
             for k, v in state.raw.items()}

    def call():
        return step.optimizer.update(grads, state.opt_state, state.raw)

    with torch.no_grad():
        return {"device_ms": device_ms(call), "events_ms": events_ms(call, reps),
                "host_us": host_ms(call, reps) * 1e3}


SPLIT = ("render_fwd", "loss_fwd", "loss_bwd", "render_bwd", "adam", "rest")


def train_step_split(step, state, args, reps: int):
    """The train step ``step(state, *args)`` of ``train/trainer.py``'s
    ``make_train_step`` split by CUDA events that the host records as it
    reaches each part: render forward (``params_from_raw`` and
    ``render_arrays``), loss forward (``losses.gs_loss``), loss backward
    (from the loss to its image input), render backward (the rest of the
    backward, PSNR and the densify statistic), Adam
    (``Optimizer.update`` and the addition to the raw tensors), and the
    rest of the events' step (a parent's trainer adds the updates to the
    raw tensors there); with the step on the host clock to a sync. Wraps
    ``losses.gs_loss`` and ``Optimizer.update`` for the call, so it times
    any checkout's trainer.
    Medians in ms of ``reps`` steps after two."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.train import losses, trainer

    ev = {}

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev[name] = e

    class Mark(torch.autograd.Function):
        """Identity whose backward records an event."""

        @staticmethod
        def forward(ctx, x, name):
            ctx.name = name
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            mark(ctx.name)
            return g, None

    loss_fn, update = losses.gs_loss, trainer.Optimizer.update

    def timed_loss(pred, target, *a, **k):
        mark("loss0")
        out = loss_fn(Mark.apply(pred, "bwd1"), target, *a, **k)
        mark("loss1")
        return Mark.apply(out, "bwd0")

    def timed_update(self, *a, **k):
        mark("adam0")
        out = update(self, *a, **k)
        mark("adam1")
        return out

    losses.gs_loss, trainer.Optimizer.update = timed_loss, timed_update
    parts = {k: [] for k in SPLIT + ("events", "host")}
    try:
        for i in range(reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark("start")
            state, metrics = step(state, *args)
            mark("end")
            float(metrics["loss"])
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            if i < 2:
                continue
            t = {"render_fwd": ("start", "loss0"), "loss_fwd": ("loss0", "loss1"),
                 "loss_bwd": ("bwd0", "bwd1"), "render_bwd": ("bwd1", "adam0"),
                 "adam": ("adam0", "adam1"), "events": ("start", "end")}
            got = {k: ev[a].elapsed_time(ev[b]) for k, (a, b) in t.items()}
            got["rest"] = got["events"] - sum(got[k] for k in SPLIT[:-1])
            got["host"] = host
            for k, v in got.items():
                parts[k].append(v)
    finally:
        losses.gs_loss, trainer.Optimizer.update = loss_fn, update
    return {k: statistics.median(v) for k, v in parts.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="the checkout whose package is timed (default: this one)")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--scenes", default=",".join(SCENES))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_turn_bench: no CUDA device")
    import numpy as np

    import openglgaussiansplattingrenderer_tpu_torch as port
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.render import (
        autotune_capacity,
        camera_args,
        render_arrays,
    )
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        raw_from_params,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    out = {"card": card, "package": str(Path(port.__file__).resolve().parent)}
    for name in args.scenes.split(","):
        n, w, h, chunk, maker, kw = SCENES[name]
        scene = getattr(ply_io, maker)(n, **kw)
        params = params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"}, dev)
        a = camera_args(port.Camera(0.0, 0.0, -8.0, width=w, height=h))
        cam = (torch.as_tensor(a["view"], device=dev), torch.as_tensor(a["vp"], device=dev),
               a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], w, h)
        cfg0 = port.RenderConfig.for_resolution(w, h, tile_px=32, chunk=chunk)
        cfg = autotune_capacity(params, *cam[:6], w, h, cfg0)

        def frame():
            with torch.no_grad():
                return render_arrays(params, *cam, cfg)

        def fwdbwd():
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            img, _ = render_arrays(p, *cam, cfg)
            return torch.autograd.grad((img[..., :3] ** 2).mean(), list(p.values()))

        row = {"frame_ms": events_ms(frame, args.reps), "frame_host_ms": host_ms(frame, args.reps),
               "frame_device_ms": device_ms(frame),
               "fwdbwd_ms": events_ms(fwdbwd, args.reps),
               "fwdbwd_host_ms": host_ms(fwdbwd, args.reps),
               "fwdbwd_device_ms": device_ms(fwdbwd)}
        if name == "uniform":
            tc = TrainConfig(lambda_dssim=0.2)
            target = frame()[0][..., :3].contiguous()
            colors = params["colors"].cpu().numpy()
            noisy = np.clip(colors + np.random.default_rng(0).normal(0, 40, colors.shape),
                            5, 250).astype(np.float32)
            step = make_train_step(cfg, tc, w, h, with_grad_norms=True)
            with torch.no_grad():
                state = step.init(raw_from_params(dict(params, colors=torch.as_tensor(
                    noisy, device=dev))))
            wall = []
            for i in range(args.reps + 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, target, *cam[:6])
                float(metrics["loss"])
                torch.cuda.synchronize()
                if i >= 2:
                    wall.append((time.perf_counter() - t0) * 1e3)
            row["train_step_ms"] = statistics.median(wall)
            one = (target, *cam[:6])
            row["train_step_events_ms"] = events_ms(lambda: step(state, *one), args.reps)
            row["train_step_device_ms"] = device_ms(lambda: step(state, *one))
            row["train_step_split"] = train_step_split(step, state, one, args.reps)
            row["step_top"] = device_top(lambda: step(state, *one))
            row["adam"] = adam_kernel(step, state, args.reps)
            row["loss_kernels"] = loss_kernels(
                render_arrays, (dict(params, colors=torch.as_tensor(noisy, device=dev)), *cam,
                                cfg), target, tc.lambda_dssim, args.reps)
            del state, step, target
        out[name] = row
        print(name, json.dumps(row), flush=True)
        del params, scene
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
