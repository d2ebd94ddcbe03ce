"""The forward render path: preprocess -> records -> sort -> compositor.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/fastpath.py``
(forward only). Stage map, kernels in ``ops/kernels``:

  preprocess (torch elementwise)                          [N]
    -> prefix sum of duplicate counts    (kernel: scan)   [N]
    -> expand to splat-major records     (kernel: expand) [C]
    -> stable (tile, depth) record sort  (torch.sort)     [C]
    -> per-tile bounds                   (searchsorted)   [T+1]
    -> tile compositor                   (kernel: composite)
    -> assemble_image

Records carry their own depth, so there is no per-splat depth sort
(``hoist_depth_sort=False``); overflow past ``capacity`` drops records in
splat order, and ``stats["overflow"]`` reports it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import projection
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import (
    assemble_image,
    padded_dims,
)
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import build_covariance

# The JAX package rounds capacity to whole expand grid steps (512-record
# sub-blocks x 8); keeping its rounding keeps num_records and overflow equal.
CAPACITY_MULTIPLE = 512 * 8


def check_supported(cfg: RenderConfig) -> None:
    """Raise for the configurations the port does not run yet."""
    if cfg.hoist_depth_sort:
        raise NotImplementedError(
            "hoist_depth_sort=True is not ported yet (ROADMAP.md, modules "
            "to port: fast-path forward)")
    if cfg.record_sort != "lax":
        raise NotImplementedError(
            "record_sort='radix' waits for the radix-sort kernels "
            "(ROADMAP.md, kernels to port: 6 and 7)")
    if cfg.sort_payload != "f32":
        raise NotImplementedError(
            "sort_payload='q16' is not ported yet (ROADMAP.md, modules to "
            "port: q16 inference mode)")


def composite_kwargs(width: int, height: int, cfg: RenderConfig) -> dict:
    """Keyword arguments of ``kernels.composite.composite`` for a frame."""
    wp, hp = padded_dims(width, height, cfg)
    return dict(pw=wp // cfg.grid_x, ph=hp // cfg.grid_y, chunk=cfg.chunk,
                alpha_min=float(cfg.alpha_min), alpha_max=float(cfg.alpha_max),
                thresh=float(1.0 - cfg.saturation))


def expand_kwargs(num_splats: int, width: int, height: int,
                  cfg: RenderConfig) -> dict:
    """Keyword arguments of ``kernels.records.expand`` for a frame."""
    wp, hp = padded_dims(width, height, cfg)
    return dict(capacity=kr.round_up(cfg.capacity(num_splats), CAPACITY_MULTIPLE),
                gx=cfg.grid_x, num_tiles=cfg.num_tiles, pw=wp // cfg.grid_x,
                ph=hp // cfg.grid_y, alpha_min=float(cfg.alpha_min))


def composite_sorted(sorted_fields: torch.Tensor, bounds: torch.Tensor, *,
                     num_tiles: int, tile_ids: torch.Tensor, width: int,
                     height: int, cfg: RenderConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite (tile, depth)-sorted records (9, C) over the tiles
    ``tile_ids`` (global ids; ``bounds`` (num_tiles+1,) holds their record
    ranges). Returns (tiled (num_tiles, p, 4), bounds, counts per tile)."""
    kw = composite_kwargs(width, height, cfg)
    ox, oy = kc.tile_origins(tile_ids, kw["pw"], kw["ph"], cfg.grid_x)
    tiled = kc.composite(sorted_fields, bounds, ox, oy, **kw)
    return tiled, bounds, bounds[1:] - bounds[:-1]


def splat_table(params: Dict[str, torch.Tensor], view, vp, focal_x, focal_y,
                tan_fovx, tan_fovy, width: int, height: int, cfg: RenderConfig):
    """Preprocess and the per-splat inputs of the expand.

    Returns ((fields (9, N), tile_min (N, 2), tile_ext (N, 2), depth (N,)),
    prep): the record fields mx, my, A, B, C, op, r, g, b, the splat's
    tile rect, and its depth (0 where invalid or non-finite).
    """
    cov6 = params.get("cov6")
    if cov6 is None:
        cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(
        params["means"], cov6, params["opacities"], view, vp,
        width, height, focal_x, focal_y, tan_fovx, tan_fovy, cfg)
    from openglgaussiansplattingrenderer_tpu_torch.render import effective_colors

    colors = effective_colors(params, view, cfg)
    mean2d = prep["mean2d"]
    if "shift2d" in params:
        mean2d = mean2d + params["shift2d"]
    fields = torch.stack([
        mean2d[:, 0], mean2d[:, 1],
        prep["conic"][:, 0], prep["conic"][:, 1], prep["conic"][:, 2],
        prep["opacity"], colors[:, 0], colors[:, 1], colors[:, 2]])
    zero = torch.zeros((), dtype=torch.float32, device=mean2d.device)
    depth = torch.where(prep["valid"], prep["depth"], zero)
    depth = torch.where(torch.isfinite(depth), depth, zero).detach()
    return (fields.contiguous(), prep["tile_min"].contiguous(),
            prep["tile_ext"].contiguous(), depth.contiguous()), prep


def expand_depth_records(params: Dict[str, torch.Tensor], view, vp, focal_x,
                         focal_y, tan_fovx, tan_fovy, width: int, height: int,
                         cfg: RenderConfig):
    """Preprocess, prefix sum and expansion to splat-major records.

    Returns (fields (9, C), tile (C,) int32, depth (C,), info) with info
    holding ``prep``, ``total`` and ``total_all`` (device scalars).
    """
    n = params["means"].shape[0]
    table, prep = splat_table(params, view, vp, focal_x, focal_y, tan_fovx,
                              tan_fovy, width, height, cfg)
    kw = expand_kwargs(n, width, height, cfg)
    cum_incl = ks.cumsum(prep["counts"])
    total_all = cum_incl[-1] if n else torch.zeros(
        (), dtype=torch.int32, device=cum_incl.device)
    total = torch.clamp_max(total_all, kw["capacity"])
    rec_f, rec_t, rec_d = kr.expand(*table, cum_incl, **kw)
    return rec_f, rec_t, rec_d, {"prep": prep, "total": total,
                                 "total_all": total_all}


def sort_records(rec_f, rec_t, rec_d, cfg: RenderConfig):
    """Stable (tile, depth) record sort and per-tile bounds.

    Returns (sorted fields (9, C), bounds (T+1,) int32)."""
    t = cfg.num_tiles
    dev = rec_f.device
    if cfg.depth_key == "packed":
        # u32 key tile * 2^22 + 22-bit depth (fastpath.py "packed")
        if t > 512:
            raise ValueError("depth_key='packed' needs num_tiles <= 512")
        key = kr.packed_key(rec_t, rec_d)
        tile_bnd = torch.arange(t + 1, dtype=torch.int64, device=dev) << 22
    else:
        # "pair" (and "reference", which the JAX fast path also sorts as
        # the exact pair): lexicographic (tile, float depth)
        key = kr.pair_key(rec_t, rec_d)
        tile_bnd = torch.arange(t + 1, dtype=torch.int64, device=dev) << 32
    sk, _, sf = kr.sort_with_payload(key, rec_f)
    bounds = torch.searchsorted(sk, tile_bnd, right=False).to(torch.int32)
    return sf, bounds


def render_fast(params: Dict[str, torch.Tensor], view, vp, focal_x, focal_y,
                tan_fovx, tan_fovy, width: int, height: int, cfg: RenderConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render one frame. Returns ((H, W, 4) image, stats) with the JAX
    package's stats keys."""
    check_supported(cfg)
    rec_f, rec_t, rec_d, info = expand_depth_records(
        params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy, width, height,
        cfg)
    prep, total, total_all = info["prep"], info["total"], info["total_all"]
    n = params["means"].shape[0]
    capacity = rec_f.shape[1]
    t = cfg.num_tiles

    sf, bounds = sort_records(rec_f, rec_t, rec_d, cfg)
    tiled, _, counts_t = composite_sorted(
        sf, bounds, num_tiles=t,
        tile_ids=torch.arange(t, dtype=torch.int32, device=sf.device),
        width=width, height=height, cfg=cfg)
    image = assemble_image(tiled[:, :, 0:3], tiled[:, :, 3], width, height, cfg)

    i32 = torch.int32
    num_visible = prep["valid"].sum(dtype=i32)
    stats = {
        "num_splats": torch.tensor(n, dtype=i32, device=sf.device),
        "num_visible": num_visible,
        "num_culled": prep["culled"].sum(dtype=i32),
        "num_records": total,
        "num_duplicates": total - num_visible,
        "overflow": torch.clamp_min(total_all - capacity, 0),
        "max_bin": counts_t.max(),
        "mean_bin": counts_t.to(torch.float32).mean(),
        "binned_records": bounds[-1],
        # records the expand's reachability cull marked invalid
        "culled_unreachable": total - bounds[-1],
    }
    return image, stats
