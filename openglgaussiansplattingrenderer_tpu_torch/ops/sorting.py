"""Depth sorting for the oracle pipeline.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/sorting.py``. The
lexicographic (tile, depth) sort is built from two stable ``torch.sort``
calls (depth, then tile), not from the fast path's one int64 key
(``ops/kernels/records.pair_key``): the oracle is held independent of the
code it checks. ``torch.sort(stable=True)`` orders floats as ``lax.sort``
does: -0.0 and +0.0 compare equal (ties keep their input order), +inf
sorts after every finite value and NaN last.

``sort_by_float_key`` reproduces the reference's packed float key
``tileIndex + ndc_z`` (``preprocess.glsl:154``) for parity testing.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sort_by_tile_depth(tile: torch.Tensor, depth: torch.Tensor,
                       values: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable lexicographic (tile, depth) sort; returns (sorted_tile,
    sorted_values)."""
    _, by_depth = torch.sort(depth, stable=True)
    sorted_tile, by_tile = torch.sort(tile[by_depth], stable=True)
    return sorted_tile, values[by_depth[by_tile]]


def sort_by_float_key(tile: torch.Tensor, depth: torch.Tensor,
                      values: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference-parity sort on the packed float32 key tile + depth.

    Invalid records carry +inf depth and sort to the end; a non-finite key
    maps to tile 2**30."""
    key = tile.to(torch.float32) + depth
    sorted_key, order = torch.sort(key, stable=True)
    big = torch.full((), 2 ** 30, dtype=torch.int32, device=key.device)
    finite = torch.isfinite(sorted_key)
    sorted_tile = torch.where(
        finite, torch.floor(torch.where(finite, sorted_key, 0.0)).to(torch.int32),
        big)
    return sorted_tile, values[order]


def argsort_floats(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort of float keys, int32 (the contract
    ``tests/sortTests.cpp`` checks for the reference sort library)."""
    return torch.sort(keys, stable=True)[1].to(torch.int32)
