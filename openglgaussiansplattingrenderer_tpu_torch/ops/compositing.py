"""Tile geometry, the oracle's dense compositor, and image assembly.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/compositing.py``.
The fast path's compositor is ``ops/kernels/composite.py``; this module
holds the oracle's: ``draw.glsl``'s sequential front-to-back blend with its
early break at 0.99 accumulated alpha, rewritten as parallel masked tensor
operations over ``(T, chunk, P)`` blocks of (tile, record, pixel):

  T_k (transmittance before record k) = exp(cumsum_exclusive(log1p(-alpha)))
  include record k  iff  T_k > 1 - saturation
  rgb = sum_k colour_k alpha_k T_k include_k
  out_alpha = 1 - prod_k (1 - alpha_k include_k)

The include mask taken on the unmasked prefix product equals the
reference's "break after the record that crosses 0.99" (once the product is
below the threshold it only shrinks). It is plain PyTorch and
differentiable by autograd; its memory is that of ``(T, chunk, P)`` float
tensors for each of the ``ceil(max_per_tile / chunk)`` chunks.

By design it loops exactly over each tile's ``[start, end)``, as the
reference's CPU path does, not over draw.glsl's whole shared-memory batch
(QUIRKS.md).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.utils import device as device_


def padded_dims(width: int, height: int, cfg: RenderConfig) -> Tuple[int, int]:
    """Image size padded up so tiles have an integer pixel size (identity
    at grid-divisible resolutions such as the reference's 1024x512 / 16)."""
    wp = -(-width // cfg.grid_x) * cfg.grid_x
    hp = -(-height // cfg.grid_y) * cfg.grid_y
    return wp, hp


def tile_pixel_coords(width: int, height: int, cfg: RenderConfig, *,
                      device: torch.device | str):
    """Pixel-centre coordinates per tile on ``device``, flattened: (T, P) x
    and y, tiles ordered ``tileY * grid_x + tileX`` (preprocess.glsl:153),
    pixels row major within a tile."""
    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    gx, gy = cfg.grid_x, cfg.grid_y
    f32 = torch.float32
    lx = torch.arange(pw, dtype=f32, device=device)
    ly = torch.arange(ph, dtype=f32, device=device)
    px = (torch.arange(gx, dtype=f32, device=device) * pw)[:, None, None] + lx  # (gx, 1, pw)
    py = (torch.arange(gy, dtype=f32, device=device) * ph)[:, None, None] + ly[:, None]
    pxs = px[None].expand(gy, gx, ph, pw).reshape(-1, ph * pw)
    pys = py[:, None].expand(gy, gx, ph, pw).reshape(-1, ph * pw)
    return pxs, pys


def gather_records(prep: Dict[str, torch.Tensor], colors: torch.Tensor,
                   sorted_sid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-splat attributes in sorted record order (draw.glsl's
    ``splatKeys[indices[i]]``); autograd's transpose of the gather sums
    each splat's duplicated records' gradients."""
    sid = sorted_sid.long()
    return {
        "mean2d": prep["mean2d"][sid],
        "conic": prep["conic"][sid],
        "color": colors[sid],
        "opacity": prep["opacity"][sid],
    }


def composite(records: Dict[str, torch.Tensor], tile_bounds: torch.Tensor,
              width: int, height: int, cfg: RenderConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Composite sorted records into an (H, W, 4) image in [0, 1]. ``aux``
    holds ``dropped_by_cap``, the records past ``max_per_tile`` that no
    chunk reached."""
    pxs, pys = tile_pixel_coords(width, height, cfg, device=tile_bounds.device)
    rgb, trans = composite_ranges(records, tile_bounds[:-1], tile_bounds[1:],
                                  pxs, pys, cfg)
    image = assemble_image(rgb, trans, width, height, cfg)
    per_tile = tile_bounds[1:] - tile_bounds[:-1]
    nchunks = -(-cfg.max_per_tile // cfg.chunk)
    dropped = torch.clamp_min(per_tile - nchunks * cfg.chunk, 0).sum(dtype=torch.int32)
    return image, {"dropped_by_cap": dropped}


def composite_ranges(records: Dict[str, torch.Tensor], starts: torch.Tensor,
                     ends: torch.Tensor, pxs: torch.Tensor, pys: torch.Tensor,
                     cfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compositor over any set of tiles: record ranges ``[starts,
    ends)`` (T_local,) and pixel coordinates ``pxs``, ``pys`` (T_local, P).
    Returns ((T_local, P, 3) premultiplied rgb in colour-scale units,
    (T_local, P) transmittance)."""
    capacity = records["mean2d"].shape[0]
    num_tiles, p = pxs.shape
    chunk = cfg.chunk
    nchunks = -(-cfg.max_per_tile // chunk)
    dev = pxs.device
    lane = torch.arange(chunk, dtype=torch.int64, device=dev)
    starts, ends = starts.long(), ends.long()
    mean2d, conic = records["mean2d"], records["conic"]
    color, opacity = records["color"], records["opacity"]
    thresh = 1.0 - cfg.saturation
    px, py = pxs[:, None, :], pys[:, None, :]

    rgb = torch.zeros((num_tiles, p, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    for k in range(nchunks):
        idx = starts[:, None] + k * chunk + lane[None, :]            # (T, chunk)
        in_range = idx < ends[:, None]
        idx_c = idx.clamp(0, capacity - 1)
        dx = px - mean2d[idx_c, 0][:, :, None]                        # (T, chunk, P)
        dy = py - mean2d[idx_c, 1][:, :, None]
        power = (-0.5 * (conic[idx_c, 0][:, :, None] * dx * dx
                         + conic[idx_c, 2][:, :, None] * dy * dy)
                 - conic[idx_c, 1][:, :, None] * dx * dy)             # draw.glsl:115-116
        alpha = torch.clamp_max(torch.exp(power) * opacity[idx_c][:, :, None],
                                cfg.alpha_max)
        keep = in_range[:, :, None] & (power <= 0.0) & (alpha >= cfg.alpha_min)
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
        lg = torch.log1p(-alpha)
        s_excl = trans[:, None, :] * torch.exp(torch.cumsum(lg, dim=1) - lg)
        include = s_excl > thresh                                     # the 0.99 break
        wgt = alpha * s_excl * include
        rgb = rgb + torch.einsum("tkp,tkc->tpc", wgt, color[idx_c])
        trans = trans * torch.exp(torch.where(include, lg, torch.zeros_like(lg)).sum(1))
    return rgb, trans


def assemble_image(rgb_tiled: torch.Tensor, trans_tiled: torch.Tensor,
                   width: int, height: int, cfg: RenderConfig) -> torch.Tensor:
    """(T, P, 3) tiled rgb + (T, P) transmittance -> (H, W, 4) in [0, 1].

    Applies the final /color_scale (draw.glsl:141) and composites the
    configured background behind the splats.
    """
    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    gx, gy = cfg.grid_x, cfg.grid_y
    rgb = rgb_tiled / cfg.color_scale
    bg = device_.constant(cfg.background, torch.float32, rgb.device)
    rgb = rgb + trans_tiled[..., None] * bg[None, None, :]
    out_alpha = 1.0 - trans_tiled
    tiled = torch.cat([rgb, out_alpha[..., None]], dim=-1)        # (T, P, 4)
    img = tiled.reshape(gy, gx, ph, pw, 4).permute(0, 2, 1, 3, 4).reshape(hp, wp, 4)
    return img[:height, :width, :]
