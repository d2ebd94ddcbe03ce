"""Inclusive 1-D prefix sum of int32 counts.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/pallas/scan.py``;
the kernel is ``csrc/scan.cu``. On the frame's path it turns the per-splat
duplicate counts into record offsets.
"""

from __future__ import annotations

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build


def cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: inclusive int32 cumsum."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D int32 tensor (exact)."""
    build.expect("cumsum", x, torch.int32, (None,))
    if not build.on_cuda("cumsum", x):
        return cumsum_plain(x)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = build.load_library()
    tile = lib.gs_cumsum_tile()
    scratch = torch.empty(-(-n // tile), dtype=torch.int32, device=x.device)
    build.check("cumsum", lib.gs_cumsum_i32(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, build.stream_ptr()))
    cumsum.launches += 1
    return out


cumsum.launches = 0
