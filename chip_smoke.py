#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``openglgaussiansplattingrenderer_tpu_torch/
csrc`` (nvcc, at first use), then:

1. prints the card, its power limit, the PyTorch version and the build time;
2. holds each kernel against its plain PyTorch version on the card at the
   render path's shapes (prefix sum and expansion on the flagship frame:
   bit-equal; compositor on the 10k-splat gate scene: image max abs diff
   <= 5e-3 with <= 10 px above 1e-3) and times both (CUDA events, median);
3. drives the render path through ``render_arrays`` at the reference's
   operating point (3,616,103 splats at 1024x512, uniform and clustered
   scenes), with every kernel launch counter reset just before and read
   just after; checks zero overflow, a finite image with coverage, every
   kernel launched, the uniform frame against the all-plain pipeline, and
   a small frame against the port's CPU path;
4. prints each flagship frame's per-stage device times (CUDA events), then
   a JSON line of per-kernel results and, last, the device line.

Every check raises on failure; the exit code is nonzero and no result line
is printed. There is no fallback: without CUDA the script exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FLAG_SPLATS = 3_616_103            # the reference's bike-big.ply
FLAG_W, FLAG_H = 1024, 512         # the reference's default resolution
GATE_SPLATS, GATE_W, GATE_H = 10_000, 512, 512
REPS = 10
GATE_MAX_ABS, GATE_MAX_PX = 5e-3, 10

PKG = "openglgaussiansplattingrenderer_tpu_torch"
TPU_PKG = "openglgaussiansplattingrenderer_tpu"
KERNELS = {
    "cumsum": (f"{PKG}/csrc/scan.cu", f"{TPU_PKG}/ops/pallas/scan.py:37"),
    "expand": (f"{PKG}/csrc/expand.cu", f"{TPU_PKG}/ops/pallas/records.py:405"),
    "composite": (f"{PKG}/csrc/composite.cu",
                  f"{TPU_PKG}/ops/pallas/composite.py:237"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def image_diff(a, b):
    """(max abs diff, pixels whose max channel diff exceeds 1e-3)."""
    d = (a - b).abs()
    return float(d.max()), int((d.amax(dim=-1) > 1e-3).sum())


class Frame:
    """One scene and camera, with the port's frame stages exposed so the
    kernels can be fed the render path's own inputs."""

    def __init__(self, scene, cam, cfg, device):
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
        from openglgaussiansplattingrenderer_tpu_torch.render import camera_args

        self.params = params_from_numpy(
            {k: v for k, v in scene.items() if k != "sh_rest"}, device)
        a = camera_args(cam)
        mat = {k: torch.as_tensor(a[k], device=device) for k in ("view", "vp")}
        self.args = (mat["view"], mat["vp"], a["focal_x"], a["focal_y"],
                     a["tan_fovx"], a["tan_fovy"], cam.width, cam.height)
        self.cfg = cfg

    @property
    def size(self):
        return self.args[6], self.args[7]

    def with_cfg(self, cfg):
        import copy

        f = copy.copy(self)
        f.cfg = cfg
        return f

    def render(self):
        from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays

        return render_arrays(self.params, *self.args, self.cfg)

    def table(self):
        """((fields, tile_min, tile_ext, depth), counts, expand kwargs)."""
        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath

        table, prep = fastpath.splat_table(self.params, *self.args, self.cfg)
        n = self.params["means"].shape[0]
        return table, prep["counts"], fastpath.expand_kwargs(n, *self.size, self.cfg)

    def composite_inputs(self, sf):
        """(ox, oy, composite kwargs) for all tiles of the frame."""
        import torch

        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc

        kw = fastpath.composite_kwargs(*self.size, self.cfg)
        t = torch.arange(self.cfg.num_tiles, dtype=torch.int32, device=sf.device)
        ox, oy = kc.tile_origins(t, kw["pw"], kw["ph"], self.cfg.grid_x)
        return ox, oy, kw

    def image(self, tiled):
        from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import assemble_image

        return assemble_image(tiled[:, :, :3], tiled[:, :, 3], *self.size, self.cfg)

    def plain_render(self):
        """The whole frame through the plain versions of every kernel."""
        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
        from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

        table, counts, ekw = self.table()
        rec = kr.expand_plain(*table, ks.cumsum_plain(counts), **ekw)
        sf, bounds = fastpath.sort_records(*rec, self.cfg)
        ox, oy, ckw = self.composite_inputs(sf)
        return self.image(kc.composite_plain(sf, bounds, ox, oy, **ckw))


def check_scan_and_expand(frame, results):
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    table, counts, kw = frame.table()
    cum = ks.cumsum(counts)
    cum_p = ks.cumsum_plain(counts)
    assert torch.equal(cum, cum_p), "cumsum kernel differs from torch.cumsum"
    err = float((cum - cum_p).abs().max())
    ms, pms = cuda_ms(lambda: ks.cumsum(counts)), cuda_ms(lambda: ks.cumsum_plain(counts))
    results["cumsum"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    log(f"[2] cumsum  n={counts.numel()} exact; kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")

    got = kr.expand(*table, cum, **kw)
    ref = kr.expand_plain(*table, cum, **kw)
    for name, a, b in zip(("fields", "tile", "depth"), got, ref):
        assert torch.equal(a, b), f"expand {name} differ from the plain version"
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref))
    ms = cuda_ms(lambda: kr.expand(*table, cum, **kw))
    pms = cuda_ms(lambda: kr.expand_plain(*table, cum, **kw))
    results["expand"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    log(f"[2] expand  C={kw['capacity']} records (total {int(cum[-1])}) "
        f"bit-equal; kernel {ms:.4f} ms, plain {pms:.4f} ms")


def check_composite(frame, results):
    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    table, counts, ekw = frame.table()
    rec = kr.expand(*table, ks.cumsum(counts), **ekw)
    sf, bounds = fastpath.sort_records(*rec, frame.cfg)
    ox, oy, kw = frame.composite_inputs(sf)
    got = kc.composite(sf, bounds, ox, oy, **kw)
    ref = kc.composite_plain(sf, bounds, ox, oy, **kw)
    err, bad = image_diff(frame.image(got), frame.image(ref))
    assert err <= GATE_MAX_ABS and bad <= GATE_MAX_PX, (
        f"compositor vs plain: max abs {err:.3e}, {bad} px > 1e-3")
    ms = cuda_ms(lambda: kc.composite(sf, bounds, ox, oy, **kw))
    pms = cuda_ms(lambda: kc.composite_plain(sf, bounds, ox, oy, **kw))
    results["composite"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    w, h = frame.size
    log(f"[2] composite gate scene ({GATE_SPLATS} splats, {w}x{h}, "
        f"{int(bounds[-1])} records): max abs {err:.3e}, {bad} px > 1e-3; "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms")


def stage_times(name, frame):
    """Median CUDA-event time of each stage of the frame (after warm-up),
    and the per-tile record counts that bound the compositor."""
    import torch

    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

    names = ("table", "cumsum", "expand", "sort", "composite", "assemble")
    times = {k: [] for k in names}
    for it in range(REPS + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        table, counts, kw = frame.table()
        ev[1].record()
        cum = ks.cumsum(counts)
        ev[2].record()
        rec = kr.expand(*table, cum, **kw)
        ev[3].record()
        sf, bounds = fastpath.sort_records(*rec, frame.cfg)
        ev[4].record()
        ox, oy, ckw = frame.composite_inputs(sf)
        tiled = kc.composite(sf, bounds, ox, oy, **ckw)
        ev[5].record()
        frame.image(tiled)
        ev[6].record()
        torch.cuda.synchronize()
        if it >= 2:
            for i, k in enumerate(names):
                times[k].append(ev[i].elapsed_time(ev[i + 1]))
    med = {k: statistics.median(v) for k, v in times.items()}
    per_tile = (bounds[1:] - bounds[:-1]).float()
    log(f"[4] {name} stages (ms, median of {REPS}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
        + f"; sum {sum(med.values()):.4f}; records per tile: max "
        f"{int(per_tile.max())}, mean {float(per_tile.mean()):.1f}, median "
        f"{float(per_tile.median()):.1f}")


def check_frame(name, frame, timed=True):
    """Render through render_arrays; check stats and image; time it."""
    import torch

    img, stats = frame.render()
    torch.cuda.synchronize()
    st = {k: v.item() for k, v in stats.items()}
    assert st["overflow"] == 0, f"{name}: overflow {st['overflow']}"
    w, h = frame.size
    assert img.shape == (h, w, 4), img.shape
    assert bool(torch.isfinite(img).all()), f"{name}: non-finite image"
    coverage = float((img[..., 3] > 0).float().mean())
    assert coverage > 0, f"{name}: empty image"
    ms = cuda_ms(frame.render) if timed else float("nan")
    log(f"[3] {name}: records {st['num_records']}, binned "
        f"{st['binned_records']}, max_bin {st['max_bin']}, coverage "
        f"{coverage:.4f}, frame {ms:.3f} ms (median of {REPS})")
    return img


def main() -> int:
    import numpy as np  # noqa: F401  (the port needs it; fail early)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import dataclasses

    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
    from openglgaussiansplattingrenderer_tpu_torch.render import autotune_capacity

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log("[1] card and power limit (nvidia-smi):")
    log(card)
    t0 = time.perf_counter()
    build.load_library()
    log(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}); kernels "
        f"built in {build.build_info['seconds']:.1f} s (load "
        f"{time.perf_counter() - t0:.1f} s): {build.build_info['path']}")
    for line in build.build_info["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            log(f"[1] ptxas {line.strip()}")

    # ---- scenes -----------------------------------------------------------
    fcfg0 = RenderConfig.for_resolution(FLAG_W, FLAG_H, tile_px=32, chunk=256)
    fcam = Camera(0.0, 0.0, -8.0, width=FLAG_W, height=FLAG_H)
    t0 = time.perf_counter()
    scenes = {
        "uniform": ply_io.make_synthetic_scene(
            FLAG_SPLATS, seed=99, extent=3.0, log_scale_range=(-5.8, -3.6)),
        "clustered": ply_io.make_clustered_scene(FLAG_SPLATS, seed=7, extent=3.0),
    }
    frames = {}
    for name, sc in scenes.items():
        f = Frame(sc, fcam, fcfg0, dev)
        f.cfg = autotune_capacity(f.params, *f.args[:6], FLAG_W, FLAG_H, fcfg0)
        frames[name] = f
    log(f"[1] flagship scenes made in {time.perf_counter() - t0:.1f} s; "
        f"grid {fcfg0.grid_x}x{fcfg0.grid_y}, capacity "
        f"{ {k: f.cfg.capacity_records for k, f in frames.items()} }")
    gcfg = RenderConfig.for_resolution(GATE_W, GATE_H, tile_px=32, chunk=256,
                                       dup_capacity_factor=8.0)
    gate = Frame(ply_io.make_synthetic_scene(GATE_SPLATS, seed=7, extent=2.5),
                 Camera(0.0, 0.0, -6.0, width=GATE_W, height=GATE_H), gcfg, dev)

    # ---- 2. kernels against their plain versions --------------------------
    results = {}
    with torch.no_grad():
        check_scan_and_expand(frames["uniform"], results)
        check_composite(gate, results)

        # ---- 3. the render path --------------------------------------------
        for fn in (ks.cumsum, kr.expand, kc.composite):
            fn.launches = 0
        img_u = check_frame("uniform pair", frames["uniform"])
        packed = dataclasses.replace(frames["uniform"].cfg, depth_key="packed")
        check_frame("uniform packed", frames["uniform"].with_cfg(packed))
        check_frame("clustered pair", frames["clustered"])
        launches = {"cumsum": ks.cumsum.launches, "expand": kr.expand.launches,
                    "composite": kc.composite.launches}
        log(f"[3] kernel launches on the render path: {launches}")
        for k, v in launches.items():
            assert v > 0, f"{k} kernel never launched on the render path"

        plain = frames["uniform"].plain_render()
        err, bad = image_diff(img_u, plain)
        log(f"[3] uniform frame vs all-plain pipeline: max abs {err:.3e}, "
            f"{bad} px > 1e-3")
        assert err <= GATE_MAX_ABS and bad <= GATE_MAX_PX, (
            "uniform frame diverges from the all-plain pipeline")

        for name in ("uniform", "clustered"):
            stage_times(f"{name} pair", frames[name])

        small = Frame(ply_io.make_synthetic_scene(150, seed=3, extent=2.0),
                      Camera(0.0, 0.0, -6.0, width=128, height=128),
                      RenderConfig(chunk=64, dup_capacity_factor=24.0), dev)
        img_c = small.render()[0]
        small_cpu = Frame(ply_io.make_synthetic_scene(150, seed=3, extent=2.0),
                          Camera(0.0, 0.0, -6.0, width=128, height=128),
                          small.cfg, torch.device("cpu"))
        img_h = small_cpu.render()[0]
        err_s = float((img_c.cpu() - img_h).abs().max())
        log(f"[3] 150-splat 128x128 frame, card vs CPU path: max abs {err_s:.3e}")
        assert err_s <= 1e-4, "small frame: card and CPU path disagree"

    # ---- 4. results ---------------------------------------------------------
    rows = []
    for name, (src, replaces) in KERNELS.items():
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     **results[name]})
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
