"""The render path: preprocess -> records -> sort -> compositor.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/fastpath.py``.
Stage map, kernels in ``ops/kernels`` (forward / backward):

  preprocess (torch elementwise / autograd)               [N]
    -> (hoist_depth_sort only) stable depth sort of the
       splat table               (torch.sort / one scatter)         [N]
    -> prefix sum of duplicate counts    (kernel: scan / integers, none)
    -> expand to splat-major records     (kernel: expand / segsum) [C]
    -> stable record sort                (see below / one scatter)  [C]
    -> per-tile bounds                   (searchsorted / integers, none)
    -> tile compositor                   (kernel: composite / composite_bwd)
    -> assemble_image

The record sort orders by (tile, depth). By default records carry their own
depth and the key is the exact pair (``depth_key="pair"``, one int64) or
one u32, tile * 2^22 + 22-bit depth (``"packed"``); overflow past
``capacity`` then drops records in splat order. With
``hoist_depth_sort=True`` the splat table is depth-sorted first, records
come out depth-ordered, the record sort is a stable sort on the tile id
alone, and overflow drops the farthest records. The single-key sorts
(packed, hoisted) run on ``torch.sort`` (``record_sort="lax"``) or on the
port's onesweep radix sort (``"radix"``: kernel radix_counts once, then
radix_scatter once a pass); the packed ``"lax"`` sort can carry
the fields quantised to five u32 words (``sort_payload="q16"``, inference
only). ``stats["overflow"]`` reports dropped records.

The frame is differentiable with respect to every float parameter: each
kernel with a gradient sits in a ``torch.autograd.Function`` whose backward
is a kernel too. Sort keys (tile, depth) and all statistics are detached.
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
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import build_covariance

# The JAX package rounds capacity to whole expand grid steps (512-record
# sub-blocks x 8); keeping its rounding keeps num_records and overflow equal.
CAPACITY_MULTIPLE = 512 * 8


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


def depth_sort_table(table, prep):
    """The ``hoist_depth_sort`` stage: the splat table and the duplicate
    counts in stable depth order, invalid splats last (depth +inf). The
    fields' cotangents go back through the sort's single scatter. Returns
    (table, counts).

    ``torch.sort`` takes -0.0 and +0.0 as equal where ``lax.sort`` puts
    -0.0 first; a valid splat lies in front of the camera, its depth is
    positive, and the two orders are the same.
    """
    fields, tile_min, tile_ext, _ = table
    inf = torch.full((), float("inf"), device=fields.device)
    key = torch.where(prep["valid"], prep["depth"], inf).detach()
    sk, si, sf = kr.sort_with_payload(key, fields)
    zero = torch.zeros((), dtype=torch.float32, device=fields.device)
    depth = torch.where(torch.isfinite(sk), sk, zero)
    return (sf.contiguous(), tile_min[si].contiguous(), tile_ext[si].contiguous(),
            depth), prep["counts"][si].contiguous()


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
    counts = prep["counts"]
    if cfg.hoist_depth_sort:
        table, counts = depth_sort_table(table, prep)
    kw = expand_kwargs(n, width, height, cfg)
    cum_incl = ks.cumsum(counts)
    total_all = cum_incl[-1] if n else torch.zeros(
        (), dtype=torch.int32, device=cum_incl.device)
    total = torch.clamp_max(total_all, kw["capacity"])
    rec_f, rec_t, rec_d = kr.expand(*table, cum_incl, **kw)
    return rec_f, rec_t, rec_d, {"prep": prep, "total": total,
                                 "total_all": total_all}


def check_sort_config(cfg: RenderConfig) -> None:
    """Raise for the record-sort options that do not compose."""
    if (cfg.record_sort == "radix" and not cfg.hoist_depth_sort
            and cfg.depth_key != "packed"):
        raise ValueError(
            "record_sort='radix' needs a single-key sort: depth_key='packed' "
            "or hoist_depth_sort=True (the 'pair' mode is two f32 keys)")
    if cfg.sort_payload == "q16" and (cfg.hoist_depth_sort
                                      or cfg.depth_key != "packed"):
        raise ValueError(
            "sort_payload='q16' packs the single-key record sort: it needs "
            "depth_key='packed' with hoist_depth_sort=False")
    if (cfg.depth_key == "packed" and not cfg.hoist_depth_sort
            and cfg.num_tiles > 512):
        raise ValueError("depth_key='packed' needs num_tiles <= 512")


def sort_records(rec_f, rec_t, rec_d, width: int, height: int,
                 cfg: RenderConfig):
    """Stable (tile, depth) record sort and per-tile bounds.

    Returns (sorted fields (9, C), bounds (T+1,) int32)."""
    check_sort_config(cfg)
    t = cfg.num_tiles
    dev = rec_f.device
    radix = cfg.record_sort == "radix"
    if cfg.hoist_depth_sort:
        # records arrive depth-ordered, so a stable sort on the tile id alone
        # suffices
        if radix:
            sk, _, sf = rx.radix_sort_with_payload(rec_t, rec_f, kr.tile_key_bits(t))
        else:
            sk, _, sf = kr.sort_with_payload(rec_t, rec_f)
        tile_bnd = torch.arange(t + 1, dtype=torch.int32, device=dev)
    elif cfg.depth_key == "packed":
        # u32 key tile * 2^22 + 22-bit depth (fastpath.py "packed")
        tile_bnd = (torch.arange(t + 1, dtype=torch.int64, device=dev)
                    << kr.PACKED_DEPTH_BITS)
        if radix:
            sk, _, sf = rx.radix_sort_with_payload(
                kr.packed_key_u32(rec_t, rec_d), rec_f, kr.packed_key_bits(t))
            # the invalid tile's keys have the top bit set: compare unsigned
            sk = kr.u32_values(sk)
        elif cfg.sort_payload == "q16":
            wp, hp = padded_dims(width, height, cfg)
            sk, sf = kr.sort_records_q16(kr.packed_key(rec_t, rec_d), rec_f, wp, hp)
        else:
            sk, _, sf = kr.sort_with_payload(kr.packed_key(rec_t, rec_d), rec_f)
    else:
        # "pair" (and "reference", which the JAX fast path also sorts as
        # the exact pair): lexicographic (tile, float depth)
        sk, _, sf = kr.sort_with_payload(kr.pair_key(rec_t, rec_d), rec_f)
        tile_bnd = torch.arange(t + 1, dtype=torch.int64, device=dev) << 32
    bounds = torch.searchsorted(sk, tile_bnd, right=False).to(torch.int32)
    return sf, bounds


def render_fast(params: Dict[str, torch.Tensor], view, vp, focal_x, focal_y,
                tan_fovx, tan_fovy, width: int, height: int, cfg: RenderConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render one frame. Returns ((H, W, 4) image, stats) with the JAX
    package's stats keys."""
    rec_f, rec_t, rec_d, info = expand_depth_records(
        params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy, width, height,
        cfg)
    prep, total, total_all = info["prep"], info["total"], info["total_all"]
    n = params["means"].shape[0]
    capacity = rec_f.shape[1]
    t = cfg.num_tiles

    sf, bounds = sort_records(rec_f, rec_t, rec_d, width, height, cfg)
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
