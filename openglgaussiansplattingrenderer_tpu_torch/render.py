"""Render entry points: parameter dict or scene + camera -> image and stats.

Counterpart of ``openglgaussiansplattingrenderer_tpu/render.py`` for the
forward frame. ``render_arrays`` keeps the JAX package's signature and
stats keys; the frame runs on the device its parameter tensors lie on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import projection
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import (
    build_covariance,
    camera_center_from_view,
    color_to_dc,
    eval_sh,
)


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


def _matrix(m, device) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32, device=device)


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
    """
    if not cfg.use_pallas:
        raise NotImplementedError(
            "use_pallas=False (the oracle pipeline) is not ported yet "
            "(ROADMAP.md, modules to port: oracle render)")
    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath

    dev = params["means"].device
    return fastpath.render_fast(params, _matrix(view, dev), _matrix(vp, dev),
                                focal_x, focal_y, tan_fovx, tan_fovy, width,
                                height, cfg)


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
        params["means"], cov6, params["opacities"], _matrix(view, dev),
        _matrix(vp, dev), width, height, focal_x, focal_y, tan_fovx, tan_fovy,
        cfg)
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
