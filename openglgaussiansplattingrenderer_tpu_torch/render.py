"""Render entry points: parameter dict or scene + camera -> image and stats.

Counterpart of ``openglgaussiansplattingrenderer_tpu/render.py``.
``render_arrays`` keeps the JAX package's signature and stats keys and runs
on the device its parameter tensors lie on: the fast path with the CUDA
kernels (``use_pallas=True``, ``ops/fastpath.py``) or the oracle pipeline
in plain PyTorch (``use_pallas=False``: ``ops/binning.py``,
``ops/sorting.py``, ``ops/compositing.composite``), which shares no kernel
with the fast path and is what the kernels are held against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch import frame_graph
from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import binning, compositing, projection
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import (
    build_covariance,
    camera_center_from_view,
    color_to_dc,
    eval_sh,
)
from openglgaussiansplattingrenderer_tpu_torch.utils import device as device_
from openglgaussiansplattingrenderer_tpu_torch.utils.timing import span


def effective_colors(params, view, cfg: RenderConfig):
    """View-dependent colour when cfg.sh_degree > 0 and SH coefficients are
    present; degree 0 is exactly the DC colours in params["colors"]."""
    sh_rest = params.get("sh_rest")
    if cfg.sh_degree <= 0 or sh_rest is None:
        return params["colors"]
    center = camera_center_from_view(view)
    d = params["means"] - center[None, :]
    d = d / torch.clamp_min(torch.linalg.vector_norm(d, dim=1, keepdim=True), 1e-12)
    dc = color_to_dc(params["colors"], cfg.color_scale)
    return eval_sh(dc, sh_rest, d, cfg.sh_degree, cfg.color_scale)


def render_arrays(
    params: Dict[str, torch.Tensor],
    view,
    vp,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    cfg: RenderConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render a splat parameter dict to an (H, W, 4) image plus stats.

    ``params`` holds means (N,3), scales (N,3), quats (N,4), opacities
    (N,), colors (N,3) (or a packed ``cov6`` (N,6) instead of
    scales/quats), all float32 on one device; ``view``/``vp`` are 4x4.

    The fast path runs through ``frame_graphs``: a frame with no gradient
    whose inputs repeat is replayed as one captured CUDA graph
    (``frame_graph.py``). ``render_arrays.captures``, ``.replays``,
    ``.eager`` and ``.capture_failures`` count frames.
    """
    with span("gs.frame"):
        dev = params["means"].device
        if cfg.use_pallas:
            return frame_graphs.render(params, view, vp, focal_x, focal_y,
                                       tan_fovx, tan_fovy, width, height, cfg)

        render_arrays.eager += 1
        view, vp = device_.matrices(view, vp, dev)
        n = params["means"].shape[0]
        cov6 = params.get("cov6")
        if cov6 is None:
            cov6 = build_covariance(params["scales"], params["quats"])
        prep = projection.preprocess(
            params["means"], cov6, params["opacities"], view, vp, width, height,
            focal_x, focal_y, tan_fovx, tan_fovy, cfg)
        recs = binning.expand_records(
            prep["counts"], prep["tile_min"], prep["tile_ext"],
            prep["depth"].detach(), cfg, cfg.capacity(n))
        sorted_sid, bounds = binning.sort_and_bin(recs, cfg)
        if "shift2d" in params:
            # a zero shift whose gradient is the screen-space positional
            # gradient (the densification statistic), as in the fast path
            prep = dict(prep, mean2d=prep["mean2d"] + params["shift2d"])
        gathered = compositing.gather_records(
            prep, effective_colors(params, view, cfg), sorted_sid)
        image, aux = compositing.composite(gathered, bounds, width, height, cfg)

        i32 = torch.int32
        num_visible = prep["valid"].sum(dtype=i32)
        stats = {
            "num_splats": torch.full((), n, dtype=i32, device=dev),
            "num_visible": num_visible,
            "num_culled": prep["culled"].sum(dtype=i32),
            "num_records": recs["total"],
            "num_duplicates": recs["total"] - num_visible,
            "overflow": recs["overflow"],
            **binning.bin_stats(bounds),
            "dropped_by_cap": aux["dropped_by_cap"],
        }
        return image, stats


render_arrays.captures = 0
render_arrays.replays = 0
render_arrays.eager = 0
render_arrays.capture_failures = 0
# the fast path's frames, one captured graph a device
frame_graphs = frame_graph.FrameGraphs(counter=render_arrays)


def render_depth(params: Dict[str, torch.Tensor], view, vp, focal_x, focal_y,
                 tan_fovx, tan_fovy, width: int, height: int,
                 cfg: RenderConfig, mode: str = "ndc", normalize: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Expected-depth map (H, W), coverage (alpha) map (H, W) and stats.

    The blend weights are linear in colour, so rendering each splat with
    its depth as colour gives E[d] = sum_k w_k d_k through ``render_arrays``
    (the kernels where ``cfg.use_pallas``), with the same weights as the
    colour frame. ``mode="ndc"``: the [0, 1] NDC z the sort orders by
    (preprocess.glsl:91-94); ``"view"``: view-space z (Camera.cpp:57-65).
    ``normalize`` divides by the accumulated alpha (0 where nothing
    covers). Differentiable like the colour frame."""
    dev = params["means"].device
    means = params["means"].to(torch.float32)
    mat = device_.matrices(view, vp, dev)[1 if mode == "ndc" else 0]
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    p2 = mx * mat[2, 0] + my * mat[2, 1] + mz * mat[2, 2] + mat[2, 3]
    if mode == "ndc":
        p3 = mx * mat[3, 0] + my * mat[3, 1] + mz * mat[3, 2] + mat[3, 3]
        d = (p2 / torch.clamp_min(p3, cfg.w_eps) + 1.0) * 0.5
    elif mode == "view":
        d = p2
    else:
        raise ValueError(f"unknown depth mode {mode!r}")

    params_d = {k: v for k, v in params.items() if k != "sh_rest"}
    params_d["colors"] = (d * cfg.color_scale)[:, None].expand(means.shape[0], 3)
    cfg_d = dataclasses.replace(cfg, sh_degree=0, background=(0.0, 0.0, 0.0))
    img, stats = render_arrays(params_d, view, vp, focal_x, focal_y, tan_fovx,
                               tan_fovy, width, height, cfg_d)
    depth, alpha = img[..., 0], img[..., 3]
    if normalize:
        depth = torch.where(alpha > 0.0, depth / torch.clamp_min(alpha, 1e-12),
                            torch.zeros_like(depth))
    return depth, alpha, stats


def render_loss(params, target, view, vp, focal_x, focal_y, tan_fovx,
                tan_fovy, width: int, height: int, cfg: RenderConfig):
    """L2 image loss, for gradient tests and fitting."""
    image, _ = render_arrays(params, view, vp, focal_x, focal_y, tan_fovx,
                             tan_fovy, width, height, cfg)
    return ((image[..., :3] - target) ** 2).mean()


def camera_args(camera) -> Dict[str, np.ndarray]:
    """Camera -> the argument bundle gpuRender receives (main.cpp:62-64)."""
    return {
        "view": np.asarray(camera.get_view_matrix()),
        "vp": np.asarray(camera.get_vp_matrix()),
        "focal_x": np.float32(camera.get_focal_x()),
        "focal_y": np.float32(camera.get_focal_y()),
        "tan_fovx": np.float32(camera.get_tan_fovy()),  # reference arg swap
        "tan_fovy": np.float32(camera.get_tan_fovx()),
    }


def _params_of(scene, device):
    if isinstance(scene, dict):
        return scene
    if device is None:
        raise ValueError("render a SplatScene with an explicit device=")
    return scene.params(device)


def render_stats(scene, camera, cfg: Optional[RenderConfig] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 device: torch.device | str | None = None):
    """Render a scene (a parameter dict, or a SplatScene with ``device``)
    from a Camera; returns (image, stats)."""
    cfg = cfg or RenderConfig()
    width = width or camera.width
    height = height or camera.height
    a = camera_args(camera)
    return render_arrays(_params_of(scene, device), a["view"], a["vp"],
                         a["focal_x"], a["focal_y"], a["tan_fovx"],
                         a["tan_fovy"], width, height, cfg)


def render(scene, camera, cfg: Optional[RenderConfig] = None,
           width: Optional[int] = None, height: Optional[int] = None,
           device: torch.device | str | None = None):
    """Render a scene from a Camera; returns the (H, W, 4) image."""
    image, _ = render_stats(scene, camera, cfg, width, height, device)
    return image


def count_records(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                  width, height, cfg) -> int:
    """Exact record count this scene and camera would allocate: the sum of
    preprocess's per-splat duplicate counts (no sort, expand or composite)."""
    dev = params["means"].device
    cov6 = params.get("cov6")
    if cov6 is None:
        cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(
        params["means"], cov6, params["opacities"], *device_.matrices(view, vp, dev),
        width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg)
    return int(prep["counts"].sum())


def quantize_capacity(records: int, margin: float = 1.1,
                      steps_per_octave: int = 8) -> int:
    """Round ``records * margin`` up to a log-quantized capacity bucket
    (~9% steps at the default)."""
    cap = max(int(records * margin), 1024)
    log_steps = steps_per_octave.bit_length() - 1
    step = max(1 << max(cap.bit_length() - 1 - log_steps, 0), 128)
    return -(-cap // step) * step


def autotune_capacity(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                      width: int, height: int, cfg: RenderConfig,
                      margin: float = 1.1) -> RenderConfig:
    """Config with ``capacity_records`` pinned to the measured record count
    (quantized, with ``margin``): capacity is the length of the expand and
    the record sort."""
    with torch.no_grad():
        total = count_records(params, view, vp, focal_x, focal_y, tan_fovx,
                              tan_fovy, width, height, cfg)
    return dataclasses.replace(
        cfg, capacity_records=quantize_capacity(total, margin))
