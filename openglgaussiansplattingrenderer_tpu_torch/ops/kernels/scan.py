"""Inclusive 1-D prefix sum of int32 counts.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/pallas/scan.py``;
the kernel is ``csrc/scan.cu``, a single-pass scan: one launch behind one
clear of its scratch, each value read once and written once. On the
frame's path it turns the per-splat duplicate counts into record offsets.
"""

from __future__ import annotations

import functools

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build


@functools.lru_cache(maxsize=1)
def _library():
    """(the kernel library, values a block scans), read once a process."""
    lib = build.load_library()
    return lib, lib.gs_cumsum_tile()


_SCRATCH_WORDS = 4096    # the least allocation: scans of up to 16.7M values
_scratch_of = {}         # (device index, stream) -> int64 tensor


def _scratch(n: int, tile: int, device, stream: int) -> torch.Tensor:
    """The scan's ticket counter and one 64-bit descriptor a tile. The C
    entry point clears what it uses on the stream before its launch, and
    launches on one stream run in turn, so one allocation a stream serves
    every call; it is replaced, never resized, when a longer scan comes."""
    need = 1 + -(-n // tile)
    key = (device.index, stream)
    scratch = _scratch_of.get(key)
    if scratch is None or scratch.numel() < need:
        scratch = torch.empty(max(need, _SCRATCH_WORDS), dtype=torch.int64,
                              device=device)
        _scratch_of[key] = scratch
    return scratch


def _check_words(name: str, t: torch.Tensor) -> None:
    """What the entry point needs of an int32 tensor beyond its shape."""
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} values exceed int32 indexing")
    if t.data_ptr() % 4:
        raise ValueError(f"{name}: int32 data must be 4-byte aligned, "
                         f"got address {t.data_ptr():#x}")


def cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: inclusive int32 cumsum."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D int32 tensor (exact; sums wrap as
    int32 does). ``x`` may be a contiguous view at any 4-byte offset: the
    kernel takes 16-byte accesses where the address allows."""
    build.expect("cumsum", x, torch.int32, (None,))
    _check_words("cumsum", x)
    if not build.on_cuda("cumsum", x):
        return cumsum_plain(x)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib, tile = _library()
    stream = build.stream_ptr()
    scratch = _scratch(n, tile, x.device, stream)
    build.check("cumsum", lib.gs_cumsum_i32(
        x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, stream))
    cumsum.launches += 1
    return out


cumsum.launches = 0
