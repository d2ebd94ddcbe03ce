"""Stable least-significant-digit radix sort of u32 keys with payload rows.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/pallas/radix_sort.py``;
the kernels are in ``csrc/radix_sort.cu``. Three phases a digit, as in the
reference's sort library (``src/sort.cpp:139-203``): per-chunk digit counts
(``radix_hist``), a digit-major exclusive prefix over the count table
(``_prefix_offsets``, on the prefix-sum kernel of ``scan``), and a stable
scatter of keys and payload rows (``radix_scatter``).

Keys are u32. PyTorch has little ``uint32`` arithmetic, so they are held
as int32 bit patterns (``torch.uint32`` tensors are accepted and viewed);
the kernels read them as unsigned, and the plain versions only shift and
mask them, which the sign does not disturb. Payload rows are 32-bit words
moved as bits, float32 and int32 alike. There is no size ceiling below
2^31 keys and no padding.

The port runs 8-bit digits (``BITS``): four passes over a 32-bit key. 4-bit
digits, the JAX package's plan, are compiled too, so the count and offset
tables can be held against the JAX ones.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan

BITS = 8          # digit width the port sorts with
CHUNK = 4096      # keys a block owns: kChunk of csrc/radix_sort.cu


def _check_digit(shift: int, bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"radix digit width must be 4 or 8 bits, got {bits}")
    if shift < 0 or shift + bits > 32:
        raise ValueError(f"radix digit [{shift}, {shift + bits}) leaves the key")


def _digits(keys: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    # the arithmetic shift smears the sign bit, and the mask takes it off
    return (keys >> shift) & ((1 << bits) - 1)


def radix_hist_plain(keys: torch.Tensor, shift: int, bits: int = BITS,
                     chunk: int = CHUNK) -> torch.Tensor:
    """The plain PyTorch version of ``radix_hist``: one ``bincount`` over
    chunk * 2^bits + digit."""
    k = 1 << bits
    n_chunks = -(-keys.shape[0] // chunk)
    at = torch.arange(keys.shape[0], device=keys.device) // chunk * k
    flat = torch.bincount(at + _digits(keys, shift, bits), minlength=n_chunks * k)
    return flat.view(n_chunks, k).to(torch.int32)


def radix_hist(keys: torch.Tensor, shift: int, bits: int = BITS) -> torch.Tensor:
    """Counts of the digit ``(key >> shift) & (2^bits - 1)`` in each chunk
    of ``CHUNK`` consecutive keys: (ceil(C / CHUNK), 2^bits) int32. ``keys``
    (C,) is int32 holding u32 bit patterns."""
    _check_digit(shift, bits)
    build.expect("radix_hist keys", keys, torch.int32, (None,))
    if not build.on_cuda("radix_hist", keys):
        return radix_hist_plain(keys, shift, bits, CHUNK)
    c = keys.shape[0]
    counts = torch.empty((-(-c // CHUNK), 1 << bits), dtype=torch.int32,
                         device=keys.device)
    if c == 0:
        return counts
    lib = _library()
    build.check("radix_hist", lib.gs_radix_hist(
        keys.data_ptr(), c, shift, bits, counts.data_ptr(), build.stream_ptr()))
    radix_hist.launches += 1
    return counts


def _library():
    lib = build.load_library()
    if lib.gs_radix_chunk() != CHUNK:
        raise RuntimeError(f"radix sort: the library's chunk is "
                           f"{lib.gs_radix_chunk()} keys, the wrapper's {CHUNK}")
    return lib


def _prefix_offsets(counts: torch.Tensor) -> torch.Tensor:
    """(n_chunks, K) counts -> (n_chunks + 1, K) int32 placement bases.

    P[c, k] = (keys with digit < k anywhere) + (digit-k keys in chunks
    < c); row n_chunks closes each digit's range. The digit-major prefix
    sum is ``scan.cumsum``, the prefix-sum kernel.
    """
    n_chunks, k = counts.shape
    if n_chunks == 0:
        return counts.new_zeros((1, k))
    flat = counts.t().contiguous().view(-1)            # digit-major
    incl = scan.cumsum(flat)
    body = (incl - flat).view(k, n_chunks).t()
    last = incl.view(k, n_chunks)[:, -1:].t()          # digit range ends
    return torch.cat([body, last], dim=0).contiguous()


def radix_scatter_plain(keys: torch.Tensor, values: torch.Tensor,
                        offs: torch.Tensor, shift: int, bits: int = BITS,
                        chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``radix_scatter``: digit by digit, the
    rank of a key among its chunk's keys of that digit is a prefix sum of
    the digit's mask along the chunk, as the TPU kernel takes it; one
    ``index_copy_`` then places keys and rows. No sort is involved."""
    c = keys.shape[0]
    n_chunks = -(-c // chunk)
    digit = torch.full((n_chunks * chunk,), -1, dtype=torch.int32, device=keys.device)
    digit[:c] = _digits(keys, shift, bits)
    digit = digit.view(n_chunks, chunk)
    dest = torch.zeros((n_chunks, chunk), dtype=torch.int32, device=keys.device)
    for d in range(1 << bits):
        mask = digit == d
        rank = torch.cumsum(mask, 1, dtype=torch.int32) - 1
        dest = torch.where(mask, offs[:n_chunks, d:d + 1] + rank, dest)
    dest = dest.view(-1)[:c].to(torch.int64)
    return (torch.empty_like(keys).index_copy_(0, dest, keys),
            torch.empty_like(values).index_copy_(1, dest, values))


def radix_scatter(keys: torch.Tensor, values: torch.Tensor, offs: torch.Tensor,
                  shift: int, bits: int = BITS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable pass: key i of chunk c with digit d goes to slot
    ``offs[c, d]`` + (keys of c before i with digit d), and column i of
    ``values`` (nv, C) int32 goes with it. ``offs`` is ``_prefix_offsets``
    of ``radix_hist``'s counts for the same shift. Returns (keys, values)
    in the new order; nothing is accumulated across blocks, so the result
    repeats bit for bit."""
    _check_digit(shift, bits)
    c = keys.shape[0]
    build.expect("radix_scatter keys", keys, torch.int32, (c,))
    build.expect("radix_scatter values", values, torch.int32, (None, c))
    build.expect("radix_scatter offs", offs, torch.int32,
                 (-(-c // CHUNK) + 1, 1 << bits))
    if not build.on_cuda("radix_scatter", keys, values, offs):
        return radix_scatter_plain(keys, values, offs, shift, bits, CHUNK)
    out_k, out_v = torch.empty_like(keys), torch.empty_like(values)
    if c == 0:
        return out_k, out_v
    lib = _library()
    build.check("radix_scatter", lib.gs_radix_scatter(
        keys.data_ptr(), values.data_ptr(), values.shape[0], c, shift, bits,
        offs.data_ptr(), out_k.data_ptr(), out_v.data_ptr(), build.stream_ptr()))
    radix_scatter.launches += 1
    return out_k, out_v


radix_hist.launches = 0
radix_scatter.launches = 0


def radix_sort(keys: torch.Tensor, values: Sequence[torch.Tensor] = (),
               key_bits: int = 32, bits: Optional[int] = None):
    """Stable LSD radix sort of u32 ``keys`` (C,) with payload ``values``.

    ``keys`` is int32 holding u32 bit patterns, or ``torch.uint32``;
    ``0xFFFFFFFF`` sorts last. ``key_bits`` bounds the key range (keys <
    2**key_bits) and sets the pass count ceil(key_bits / bits): the bit
    length of ``num_tiles`` for a tile-only sort, 32 for arbitrary keys.
    Each of ``values`` is a (C,) tensor of a 32-bit type, moved as bits.
    ``bits`` is the digit width, 4 or 8 (``BITS`` when not given).

    Returns (sorted keys in the dtype given, tuple of sorted value
    tensors). Exact and stable: equal keys keep their input order.
    """
    bits = BITS if bits is None else bits
    _check_digit(0, bits)
    if keys.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"radix_sort keys must be (u)int32, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError(f"radix_sort keys must be 1-D, got {tuple(keys.shape)}")
    if not 1 <= key_bits <= 32:
        raise ValueError(f"radix_sort key_bits must be in [1, 32], got {key_bits}")
    for v in values:
        if v.shape != keys.shape or v.element_size() != 4:
            raise ValueError("radix_sort values must match the keys' shape and "
                             "hold 32-bit elements")
    if keys.shape[0] >= 2 ** 31:
        raise ValueError(f"radix_sort: {keys.shape[0]} keys exceed int32 offsets")
    k = keys.contiguous().view(torch.int32)
    rows = [v.contiguous().view(torch.int32) for v in values]
    v = torch.stack(rows) if rows else k.new_empty((0, k.shape[0]))
    for p in range(-(-key_bits // bits)):
        offs = _prefix_offsets(radix_hist(k, p * bits, bits))
        k, v = radix_scatter(k, v, offs, p * bits, bits)
    return k.view(keys.dtype), tuple(
        row.view(src.dtype) for row, src in zip(v, values))


class RadixSortWithPayload(torch.autograd.Function):
    """``records.SortWithPayload`` on the radix engine: the sort carries one
    payload row, the int32 source index, and the fields are gathered once
    by it. The backward is the same single ``index_copy_``."""

    @staticmethod
    def forward(ctx, key, fields, key_bits):
        idx = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
        sk, (si,) = radix_sort(key, (idx,), key_bits)
        ctx.save_for_backward(si)
        ctx.mark_non_differentiable(sk, si)
        return sk, si, fields.index_select(1, si)

    @staticmethod
    def backward(ctx, _g_key, _g_idx, g_fields):
        (si,) = ctx.saved_tensors
        return None, torch.empty_like(g_fields).index_copy_(
            1, si.to(torch.int64), g_fields), None


def radix_sort_with_payload(key: torch.Tensor, fields: torch.Tensor,
                            key_bits: int = 32):
    """``records.sort_with_payload`` on the radix engine: stable sort by the
    u32 ``key`` (int32 bit patterns); returns (sorted_key, source_idx
    int32, sorted_fields) with ``fields`` (F, C) gathered along the record
    axis, differentiable with respect to ``fields``. The key gets no
    gradient."""
    return RadixSortWithPayload.apply(key, fields, key_bits)
