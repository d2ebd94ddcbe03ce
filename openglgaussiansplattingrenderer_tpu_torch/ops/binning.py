"""Static-shape tile binning with splat duplication, for the oracle pipeline.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/binning.py``: the
gather formulation of the reference's atomic-counter duplication
(``shaders/preprocess.glsl:157-189``). Record r of a capacity-C array
belongs to splat ``s(r) = searchsorted(cumsum(counts), r, 'right')`` with
duplicate slot ``j = r - offset[s]``; its tile follows from the splat's
tile rectangle. Records past C are dropped and counted (``overflow``).

The capacity is ``cfg.capacity(n)``, as in the JAX oracle, and there is no
reachability cull: ``total`` and the bin statistics equal the JAX oracle's,
and differ from the fast path's (``ops/fastpath.py``) by design.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import sorting


def expand_records(
    counts: torch.Tensor,     # (N,) int32 tiles overlapped per splat
    tile_min: torch.Tensor,   # (N, 2) int32
    tile_ext: torch.Tensor,   # (N, 2) int32
    depth: torch.Tensor,      # (N,) float32
    cfg: RenderConfig,
    capacity: int,
) -> Dict[str, torch.Tensor]:
    """Expand per-splat tile ranges into a capacity-padded record array.

    Returns (C,) ``splat_id``, ``tile``, ``depth``, ``valid`` and scalar
    ``total`` / ``overflow``."""
    i32 = torch.int32
    n = counts.shape[0]
    cum = torch.cumsum(counts, 0, dtype=i32)            # inclusive
    total = cum[-1]
    r = torch.arange(capacity, dtype=i32, device=counts.device)
    s = torch.searchsorted(cum, r, right=True).to(i32).clamp_max(n - 1)
    offset = cum[s] - counts[s]                          # exclusive offset of s
    j = r - offset                                       # duplicate slot
    valid = r < total

    ext_x = tile_ext[s, 0].clamp_min(1)
    tx = tile_min[s, 0] + j % ext_x
    ty = tile_min[s, 1] + j // ext_x
    tile = torch.where(valid, ty * cfg.grid_x + tx,
                       torch.full_like(tx, cfg.num_tiles)).to(i32)
    inf = torch.full((), float("inf"), dtype=depth.dtype, device=depth.device)
    return {
        "splat_id": torch.where(valid, s, torch.zeros_like(s)),
        "tile": tile,
        "depth": torch.where(valid, depth[s], inf),
        "valid": valid,
        "total": total,
        "overflow": torch.clamp_min(total - capacity, 0),
    }


def sort_and_bin(records: Dict[str, torch.Tensor], cfg: RenderConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-sort records within tiles and build per-tile ranges.

    Returns (sorted_splat_id (C,), tile_bounds (T+1,) int32): tile t's
    records are ``[tile_bounds[t], tile_bounds[t+1])`` of the sorted order
    (the reference's scanned bins buffer, ``draw.glsl:82-89``)."""
    sort = (sorting.sort_by_float_key if cfg.depth_key == "reference"
            else sorting.sort_by_tile_depth)
    sorted_tile, sorted_sid = sort(records["tile"], records["depth"],
                                   records["splat_id"])
    edges = torch.arange(cfg.num_tiles + 1, dtype=torch.int32,
                         device=sorted_tile.device)
    bounds = torch.searchsorted(sorted_tile, edges, right=False).to(torch.int32)
    return sorted_sid, bounds


def bin_stats(tile_bounds: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-frame binning stats the reference prints
    (``Splats.cpp:766,957-963``)."""
    per_tile = tile_bounds[1:] - tile_bounds[:-1]
    return {
        "max_bin": per_tile.max(),
        "mean_bin": per_tile.to(torch.float32).mean(),
        "binned_records": tile_bounds[-1],
    }
