"""EWA screen-space projection ("preprocess") on torch tensors.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/projection.py``
(itself the vectorised ``shaders/preprocess.glsl``), with the same
formulas in the same operation order so float outputs agree to rounding
and the integer tile rectangles agree exactly.
"""

from __future__ import annotations

from typing import Dict

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import padded_dims
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import (
    covariance_quadratic_form,
)

_I32_MAX = float(2 ** 31 - 128)   # largest f32 below 2^31


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 truncating toward zero, with XLA's saturating
    semantics (NaN -> 0, out of range clamps) instead of C's undefined
    behaviour, so non-finite splats give the JAX package's tile ranges."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-_I32_MAX, _I32_MAX)
    return x.to(torch.int32)


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def preprocess(
    means: torch.Tensor,       # (N, 3)
    cov6: torch.Tensor,        # (N, 6) packed 3D covariance
    opacities: torch.Tensor,   # (N,)
    view: torch.Tensor,        # (4, 4)
    vp: torch.Tensor,          # (4, 4) projection @ view
    width: int,
    height: int,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
    cfg: RenderConfig,
) -> Dict[str, torch.Tensor]:
    """Project all splats to screen space. Returns per-splat tensors with
    the JAX package's keys and layouts."""
    f32 = torch.float32
    dev = means.device
    means = means.to(f32)

    # --- projection of the mean (preprocess.glsl:77-94) -------------------
    def apply_mat4(mat):
        mat = mat.to(f32)
        mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
        return [mx * mat[j, 0] + my * mat[j, 1] + mz * mat[j, 2] + mat[j, 3]
                for j in range(4)]

    p0, p1, p2, p3 = apply_mat4(vp)
    w = torch.clamp_min(p3, cfg.w_eps)
    ndc = torch.stack([p0 / w, p1 / w, p2 / w], dim=1)
    culled = (ndc[:, 0].abs() > 1.0) | (ndc[:, 1].abs() > 1.0)
    sx = (ndc[:, 0] + 1.0) * 0.5 * width
    sy = (ndc[:, 1] + 1.0) * 0.5 * height
    z01 = (ndc[:, 2] + 1.0) * 0.5

    # --- view-space position with fov clamp (preprocess.glsl:110-116) -----
    # Reference quirk kept verbatim: limx = -margin * tanFov and the clamp
    # is written min(limx, max(-limx, x)).
    t0, t1, t2, _ = apply_mat4(view)
    tz = t2
    limx = -cfg.fov_margin * _scalar(tan_fovx, dev)
    limy = -cfg.fov_margin * _scalar(tan_fovy, dev)
    txtz = t0 / tz
    tytz = t1 / tz
    tx = torch.minimum(limx, torch.maximum(-limx, txtz)) * tz
    ty = torch.minimum(limy, torch.maximum(-limy, tytz)) * tz

    # --- EWA 2D covariance (preprocess.glsl:118-128) ----------------------
    v3 = view[:3, :3].to(f32)
    inv_tz = 1.0 / tz
    fx = _scalar(focal_x, dev)
    fy = _scalar(focal_y, dev)
    u0 = (fx * inv_tz)[:, None] * v3[0, :][None, :] - (
        fx * tx * inv_tz * inv_tz)[:, None] * v3[2, :][None, :]
    u1 = (fy * inv_tz)[:, None] * v3[1, :][None, :] - (
        fy * ty * inv_tz * inv_tz)[:, None] * v3[2, :][None, :]
    a2d = covariance_quadratic_form(cov6, u0, u0) + cfg.dilation
    b2d = covariance_quadratic_form(cov6, u0, u1)
    c2d = covariance_quadratic_form(cov6, u1, u1) + cfg.dilation

    det = a2d * c2d - b2d * b2d
    degenerate = ((det == 0.0) | ~torch.isfinite(det) | ~torch.isfinite(sx)
                  | ~torch.isfinite(sy))
    valid = ~culled & ~degenerate
    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / safe_det
    conic = torch.stack([c2d * inv_det, -b2d * inv_det, a2d * inv_det], dim=1)

    opacities = opacities.to(f32)
    if cfg.antialiased:
        # opacity compensation: sqrt(det before dilation / det after)
        det_nodil = ((a2d - cfg.dilation) * (c2d - cfg.dilation) - b2d * b2d)
        comp = torch.sqrt(torch.clamp_min(det_nodil, 1e-30)
                          / torch.clamp_min(det, 1e-30))
        opacities = opacities * torch.where(valid, comp, torch.ones_like(comp))

    # --- bounding radius via eigenvalues (preprocess.glsl:139-142) --------
    mid = 0.5 * (a2d + c2d)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, cfg.eig_floor))
    radius = torch.ceil(cfg.radius_sigma * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

    # --- tile range (preprocess.glsl:143-153) -----------------------------
    gx, gy = cfg.grid_x, cfg.grid_y
    if cfg.int_tile_size:
        tile_w, tile_h = cfg.tile_size(width, height)
    else:
        # the divisor is the compositor's padded tile pitch (see the JAX
        # package's note: identity at grid-divisible resolutions)
        wp_t, hp_t = padded_dims(width, height, cfg)
        tile_w, tile_h = wp_t / gx, hp_t / gy
    reach = valid
    if cfg.tight_rect:
        # opacity-aware ellipse AABB of the {alpha >= alpha_min} set,
        # intersected with the 3-sigma square (image-exact)
        lam = torch.log(torch.clamp_min(opacities, 1e-30) / cfg.alpha_min)
        two_l = 2.0 * torch.clamp_min(lam, 0.0)
        rx = torch.minimum(radius, torch.sqrt(two_l * torch.clamp_min(a2d, 0.0)) + 1e-3)
        ry = torch.minimum(radius, torch.sqrt(two_l * torch.clamp_min(c2d, 0.0)) + 1e-3)
        rx, ry = rx.detach(), ry.detach()
        reach = valid & (opacities >= cfg.alpha_min)
    else:
        rx = ry = radius
    tmin_x = _to_i32((sx - rx) / tile_w).clamp(0, gx - 1)
    tmax_x = _to_i32((sx + rx) / tile_w).clamp(0, gx - 1)
    tmin_y = _to_i32((sy - ry) / tile_h).clamp(0, gy - 1)
    tmax_y = _to_i32((sy + ry) / tile_h).clamp(0, gy - 1)
    ext_x = tmax_x - tmin_x + 1
    ext_y = tmax_y - tmin_y + 1
    counts = torch.where(reach, ext_x * ext_y, torch.zeros_like(ext_x))

    return {
        "mean2d": torch.stack([sx, sy], dim=1),           # (N, 2) pixels
        "conic": conic,                                   # (N, 3) (A, B, C)
        "opacity": opacities,
        "depth": z01,                                     # (N,) ndc z in [0, 1]
        "radius": radius,                                 # (N,)
        "tile_min": torch.stack([tmin_x, tmin_y], dim=1),  # (N, 2) int32
        "tile_ext": torch.stack([ext_x, ext_y], dim=1),    # (N, 2) int32
        "counts": counts.to(torch.int32),                 # (N,) tiles overlapped
        "valid": valid,                                   # (N,) bool
        "culled": culled,                                 # (N,) bool (frustum)
    }
