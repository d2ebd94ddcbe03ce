"""Tile geometry and image assembly around the compositor.

Counterpart of the ``padded_dims`` / ``assemble_image`` part of
``openglgaussiansplattingrenderer_tpu/ops/compositing.py``; the compositor
itself is ``ops/kernels/composite.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig


def padded_dims(width: int, height: int, cfg: RenderConfig) -> Tuple[int, int]:
    """Image size padded up so tiles have an integer pixel size (identity
    at grid-divisible resolutions such as the reference's 1024x512 / 16)."""
    wp = -(-width // cfg.grid_x) * cfg.grid_x
    hp = -(-height // cfg.grid_y) * cfg.grid_y
    return wp, hp


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
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=rgb.device)
    rgb = rgb + trans_tiled[..., None] * bg[None, None, :]
    out_alpha = 1.0 - trans_tiled
    tiled = torch.cat([rgb, out_alpha[..., None]], dim=-1)        # (T, P, 4)
    img = tiled.reshape(gy, gx, ph, pw, 4).permute(0, 2, 1, 3, 4).reshape(hp, wp, 4)
    return img[:height, :width, :]
