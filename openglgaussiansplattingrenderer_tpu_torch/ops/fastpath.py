"""The render path: preprocess -> records -> sort -> compositor.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/fastpath.py``.
Stage map, kernels in ``ops/kernels`` (forward / backward):

  preprocess + splat table        (kernel: splat_table / splat_table_bwd) [N]
    -> (hoist_depth_sort only) stable depth sort of the
       splat table               (torch.sort / one scatter)         [N]
    -> prefix sum of duplicate counts    (kernel: scan / integers, none)
    -> expand to splat-major records     (kernel: expand / segsum) [C]
    -> stable record sort + bounds       (see below / record_unsort) [C]
    -> tile compositor                   (kernel: composite / composite_bwd)
    -> assemble_image

The record sort orders by (tile, depth). By default records carry their own
depth and the key is the exact pair (``depth_key="pair"``: the tile id
and the depth's order-kept bits, two u32 words) or one u32, tile * 2^22 +
22-bit depth (``"packed"``); the expansion kernel writes the key word,
and the record sort stage (``kernels/record_sort.py``, either
``record_sort`` route) sorts by it on the port's kernels: one count of
every pass's digits and of every tile, whose last block writes the bounds,
a radix_scatter a pass, then one gather of the nine field rows by the
sorted index, and the same gather of the cotangents back. Overflow past
``capacity`` then drops records in splat order. With ``hoist_depth_sort=True`` the splat table is
depth-sorted first, records come out depth-ordered, the record sort is a
stable sort on the tile id alone, and overflow drops the farthest records;
it runs on ``torch.sort`` (``record_sort="lax"``) or on the port's onesweep
radix sort (``"radix"``: kernel radix_counts once, then radix_scatter once
a pass). The packed ``"lax"`` sort can carry the fields quantised to five
u32 words (``sort_payload="q16"``, inference only, ``torch.sort``).
``stats["overflow"]`` reports dropped records.

The frame is differentiable with respect to every float parameter: each
kernel with a gradient sits in a ``torch.autograd.Function`` whose backward
is a kernel too. Sort keys (tile, depth) and all statistics are detached.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import (
    assemble_image,
    padded_dims,
)
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt

# The JAX package rounds capacity to whole expand grid steps (512-record
# sub-blocks x 8); keeping its rounding keeps num_records and overflow equal.
CAPACITY_MULTIPLE = 512 * 8

# The frame's stages in order, the names ``stop_after`` takes.
STAGES = ("prep", "sort1", "cumsum", "expand", "sort2")


class Stopped(NamedTuple):
    """What a frame cut by ``stop_after`` returns: the stage's output and
    its aux dict, as ``render_fast``'s ``(out, aux)``."""
    out: torch.Tensor
    aux: dict


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


# Preprocess and the per-splat inputs of the expand: kernel splat_table (and
# its backward) on CUDA tensors, the plain version on CPU tensors.
splat_table = kt.splat_table


def depth_sort_table(table, prep):
    """The ``hoist_depth_sort`` stage: the splat table and the duplicate
    counts in stable depth order, invalid splats last (depth +inf). The
    fields' cotangents go back through the sort's single scatter. Returns
    (table, counts).

    ``torch.sort(stable=True)`` orders floats as ``lax.sort`` does (-0.0
    equal to +0.0, +inf after every finite value, NaN last:
    ``tests/test_torch_binning.py``).
    """
    fields, tile_min, tile_ext, _ = table
    inf = torch.full((), float("inf"), device=fields.device)
    key = torch.where(prep["valid"], prep["depth"], inf).detach()
    # the JAX package's hoisted sort carries 13 rows (these 9 and four
    # integer rows), so under the bf16 cotangent mode all 9 float rows are
    # paired there: round all 9 here too
    sk, si, sf = kr.sort_with_payload(key, fields, paired_rows=fields.shape[0])
    zero = torch.zeros((), dtype=torch.float32, device=fields.device)
    depth = torch.where(torch.isfinite(sk), sk, zero)
    return (sf.contiguous(), tile_min[si].contiguous(), tile_ext[si].contiguous(),
            depth), prep["counts"][si].contiguous()


def record_key(cfg: RenderConfig) -> Optional[str]:
    """The key of the record sort stage (``kernels/record_sort.py``) under
    ``cfg``: "pair" or "packed", or None where another sort runs
    (``hoist_depth_sort``, q16)."""
    if cfg.hoist_depth_sort or cfg.sort_payload == "q16":
        return None
    return "packed" if cfg.depth_key == "packed" else "pair"


def expand_depth_records(params: Dict[str, torch.Tensor], view, vp, focal_x,
                         focal_y, tan_fovx, tan_fovy, width: int, height: int,
                         cfg: RenderConfig, *, stop_after: str | None = None,
                         key: str | None = None):
    """Preprocess, prefix sum and expansion to splat-major records.

    Returns (fields (9, C), tile (C,) int32, depth (C,), info) with info
    holding ``prep``, ``total`` and ``total_all`` (device scalars), and with
    ``key`` ("pair", "packed") ``sort_word``, the record sort's word the
    expansion wrote; with ``stop_after`` one of "prep", "sort1", "cumsum",
    "expand", a ``Stopped`` (``render_fast`` says what each holds).
    """
    if stop_after is not None and stop_after not in STAGES:
        # the JAX package renders the whole frame then
        raise ValueError(f"stop_after must be one of {STAGES} or None, "
                         f"got {stop_after!r}")
    n = params["means"].shape[0]
    table, prep = splat_table(params, view, vp, focal_x, focal_y, tan_fovx,
                              tan_fovy, width, height, cfg)
    if stop_after == "prep":
        return Stopped(prep["mean2d"], {"conic": prep["conic"],
                                        "colors": table[0][6:9].t(),
                                        "depth": prep["depth"]})
    counts = prep["counts"]
    if cfg.hoist_depth_sort:
        table, counts = depth_sort_table(table, prep)
    fields, tile_min, tile_ext, _ = table
    if stop_after == "sort1":
        return Stopped(fields[0], {"fields": fields, "tile_min": tile_min,
                                   "tile_ext": tile_ext, "counts": counts})
    kw = expand_kwargs(n, width, height, cfg)
    cum_incl = ks.cumsum(counts)
    if stop_after == "cumsum":
        return Stopped(cum_incl, {"fields": fields})
    total_all = cum_incl[-1] if n else torch.zeros(
        (), dtype=torch.int32, device=cum_incl.device)
    total = torch.clamp_max(total_all, kw["capacity"])
    rec_f, rec_t, rec_d, *word = kr.expand(*table, cum_incl, **kw, key=key)
    if stop_after == "expand":
        return Stopped(rec_f, {"tile": rec_t, "depth": rec_d})
    info = {"prep": prep, "total": total, "total_all": total_all}
    if word:
        info["sort_word"] = word[0]
    return rec_f, rec_t, rec_d, info


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
                 cfg: RenderConfig, word: torch.Tensor | None = None):
    """Stable (tile, depth) record sort and per-tile bounds. ``word`` is the
    expansion's sort word (``expand_depth_records(key=record_key(cfg))``);
    where it is not given the stage builds it from ``rec_t`` and ``rec_d``.

    Returns (sorted fields (9, C), bounds (T+1,) int32)."""
    check_sort_config(cfg)
    t = cfg.num_tiles
    dev = rec_f.device
    radix = cfg.record_sort == "radix"
    key = record_key(cfg)
    if key is not None:
        # the record sort stage: pair, or packed on either route (the
        # "radix" route's plain version on the CPU is the kernels' passes)
        return rs.record_sort(rec_f, rs.words_of(rec_t, rec_d, key, word), t, key,
                              passes_model=radix)
    if cfg.hoist_depth_sort:
        # records arrive depth-ordered, so a stable sort on the tile id alone
        # suffices
        if radix:
            sk, _, sf = rx.radix_sort_with_payload(rec_t, rec_f, kr.tile_key_bits(t))
        else:
            sk, _, sf = kr.sort_with_payload(rec_t, rec_f)
        tile_bnd = torch.arange(t + 1, dtype=torch.int32, device=dev)
    else:
        # q16: the packed key, u32 tile * 2^22 + 22-bit depth, on torch.sort
        tile_bnd = (torch.arange(t + 1, dtype=torch.int64, device=dev)
                    << kr.PACKED_DEPTH_BITS)
        wp, hp = padded_dims(width, height, cfg)
        sk, sf = kr.sort_records_q16(kr.packed_key(rec_t, rec_d), rec_f, wp, hp)
    bounds = torch.searchsorted(sk, tile_bnd, right=False).to(torch.int32)
    return sf, bounds


def render_fast(params: Dict[str, torch.Tensor], view, vp, focal_x, focal_y,
                tan_fovx, tan_fovy, width: int, height: int, cfg: RenderConfig,
                stop_after: str | None = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Render one frame. Returns ((H, W, 4) image, stats) with the JAX
    package's stats keys.

    ``stop_after`` cuts the frame after a stage and returns that stage's
    (out, aux) instead, the JAX package's names and cut points (what
    ``scripts/torch_profile_stages.py`` times, prefix by prefix):

    - "prep": mean2d (N, 2), {"conic", "colors", "depth"};
    - "sort1": the splat table, depth-sorted under ``hoist_depth_sort``
      (else unsorted): fields[0], {"fields" (9, N), "tile_min" (N, 2),
      "tile_ext" (N, 2), "counts" (N,)};
    - "cumsum": the inclusive prefix sum of the counts, {"fields"};
    - "expand": the record fields (9, C), {"tile" (C,), "depth" (C,)};
    - "sort2": sorted fields[0], {"fields" (9, C), "bounds" (T+1,)}.

    Rows: the port's (9, ·) fields are rows 0-8 of the JAX package's
    record slab and of its 13-row splat table (mx, my, A, B, C, opacity,
    r, g, b); the slab's row 9 is "tile" and row 10 "depth"; the table's
    rows 9-12 are tile_min x, y, tile_ext x and the counts. An unknown
    name raises ``ValueError``.
    """
    stage = expand_depth_records(
        params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy, width, height,
        cfg, stop_after=stop_after, key=record_key(cfg))
    if isinstance(stage, Stopped):
        return tuple(stage)
    rec_f, rec_t, rec_d, info = stage
    prep, total, total_all = info["prep"], info["total"], info["total_all"]
    n = params["means"].shape[0]
    capacity = rec_f.shape[1]
    t = cfg.num_tiles

    sf, bounds = sort_records(rec_f, rec_t, rec_d, width, height, cfg,
                              word=info.get("sort_word"))
    if stop_after == "sort2":
        return sf[0], {"fields": sf, "bounds": bounds}
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
