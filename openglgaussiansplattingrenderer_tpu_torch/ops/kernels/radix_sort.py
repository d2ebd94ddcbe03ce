"""Stable least-significant-digit radix sort of u32 keys with payload rows.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/pallas/radix_sort.py``;
the kernels are in ``csrc/radix_sort.cu``, a onesweep sort: one launch counts
the digits of every pass over the whole array (``radix_counts``), then one
launch a pass places keys and payload rows (``radix_scatter``). The scatter
sorts its chunk of ``CHUNK`` keys by digit in shared memory, finds the
chunk's base of each digit by decoupled look-back over the chunks before it,
and stores runs of equal digits together. A sort of p passes is 1 + p
launches behind one clear of its scratch.

Keys are u32. PyTorch has little ``uint32`` arithmetic, so they are held
as int32 bit patterns (``torch.uint32`` tensors are accepted and viewed);
the kernels read them as unsigned, and the plain versions only shift and
mask them, which the sign does not disturb. Payload rows are 32-bit words
moved as bits, float32 and int32 alike. There is no size ceiling below
2^31 keys and no padding.

The port runs 8-bit digits (``BITS``): four passes over a 32-bit key. 4-bit
digits, the JAX package's plan, are compiled too, so the counts and the
chunk offsets can be held against the JAX ones.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.utils.timing import span

BITS = 8          # digit width the port sorts with
CHUNK = 4096      # keys a scatter block owns: kChunk of csrc/radix_sort.cu


def _check_digit(shift: int, bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"radix digit width must be 4 or 8 bits, got {bits}")
    if shift < 0 or shift + bits > 32:
        raise ValueError(f"radix digit [{shift}, {shift + bits}) leaves the key")


def _digits(keys: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    # the arithmetic shift smears the sign bit, and the mask takes it off
    return (keys >> shift) & ((1 << bits) - 1)


def passes_of(key_bits: int, bits: int) -> int:
    """Passes of ``bits``-bit digits that sort keys below 2**key_bits."""
    return -(-key_bits // bits)


def radix_counts_plain(keys: torch.Tensor, key_bits: int = 32,
                       bits: int = BITS) -> torch.Tensor:
    """The plain PyTorch version of ``radix_counts``: one ``bincount`` a
    pass."""
    return torch.stack([
        torch.bincount(_digits(keys, p * bits, bits), minlength=1 << bits)
        for p in range(passes_of(key_bits, bits))]).to(torch.int32)


@functools.lru_cache(maxsize=1)
def _library_chunk():
    """(the kernel library, keys a scatter block owns there), read once a
    process."""
    lib = build.load_library()
    return lib, lib.gs_radix_chunk()


def _library():
    lib, chunk = _library_chunk()
    if chunk != CHUNK:
        raise RuntimeError(f"radix sort: the library's chunk is "
                           f"{chunk} keys, the wrapper's {CHUNK}")
    return lib


def _launch_counts(keys: torch.Tensor, passes: int, bits: int, counts: int,
                   clear: int, clear_bytes: int) -> None:
    """One clear of ``clear_bytes`` at address ``clear`` (which must cover
    the (passes, 2^bits) table at address ``counts``), then the count."""
    build.check("radix_counts", _library().gs_radix_counts(
        keys.data_ptr(), keys.shape[0], passes, bits, counts, clear, clear_bytes,
        build.stream_ptr()))
    if keys.shape[0]:
        radix_counts.launches += 1


def radix_counts(keys: torch.Tensor, key_bits: int = 32,
                 bits: Optional[int] = None) -> torch.Tensor:
    """Counts of every pass's digit over all of ``keys``: row p of the
    (ceil(key_bits / bits), 2^bits) int32 result counts ``(key >> p * bits)
    & (2^bits - 1)``. ``keys`` (C,) is int32 holding u32 bit patterns. On
    CUDA tensors one clear and one launch; the counts are integer sums, the
    same from run to run."""
    bits = BITS if bits is None else bits
    _check_digit(0, bits)
    if not 1 <= key_bits <= 32:
        raise ValueError(f"radix_counts key_bits must be in [1, 32], got {key_bits}")
    build.expect("radix_counts keys", keys, torch.int32, (None,))
    if not build.on_cuda("radix_counts", keys):
        return radix_counts_plain(keys, key_bits, bits)
    passes = passes_of(key_bits, bits)
    counts = torch.empty((passes, 1 << bits), dtype=torch.int32, device=keys.device)
    _launch_counts(keys, passes, bits, counts.data_ptr(), counts.data_ptr(),
                   counts.nbytes)
    return counts


def radix_hist_plain(keys: torch.Tensor, shift: int, bits: int = BITS,
                     chunk: int = CHUNK) -> torch.Tensor:
    """Counts of the digit ``(key >> shift) & (2^bits - 1)`` in each chunk
    of ``chunk`` consecutive keys, (ceil(C / chunk), 2^bits) int32: one
    ``bincount`` over chunk * 2^bits + digit. What the scatter's phase A
    counts in a block, and the JAX ``_histogram``."""
    k = 1 << bits
    n_chunks = -(-keys.shape[0] // chunk)
    at = torch.arange(keys.shape[0], device=keys.device) // chunk * k
    flat = torch.bincount(at + _digits(keys, shift, bits), minlength=n_chunks * k)
    return flat.view(n_chunks, k).to(torch.int32)


def _prefix_offsets_plain(counts: torch.Tensor) -> torch.Tensor:
    """(n_chunks, K) chunk counts -> (n_chunks + 1, K) int32 placement bases,
    the JAX ``_prefix_offsets``: P[c, k] = (keys with digit < k anywhere) +
    (digit-k keys in chunks < c); row n_chunks closes each digit's range. A
    transpose to digit-major order, one inclusive ``cumsum``, and the rows
    put back together."""
    rows, cols = counts.shape
    if rows == 0:
        return counts.new_zeros((1, cols))
    flat = counts.t().contiguous().view(-1)             # digit-major
    incl = torch.cumsum(flat, 0, dtype=torch.int32)
    body = (incl - flat).view(cols, rows).t()
    last = incl.view(cols, rows)[:, -1:].t()            # digit range ends
    return torch.cat([body, last], dim=0).contiguous()


def chunk_offsets_plain(keys: torch.Tensor, counts: torch.Tensor, shift: int,
                        bits: int = BITS, chunk: int = CHUNK) -> torch.Tensor:
    """What the scatter's look-back gives its chunks, (n_chunks + 1, 2^bits)
    int32: the digit's global base (the exclusive scan over digits of this
    pass's ``counts``) plus the digit's keys in the chunks before. Equal to
    ``_prefix_offsets_plain(radix_hist_plain(keys, ...))`` when ``counts``
    are the pass's true counts."""
    hist = radix_hist_plain(keys, shift, bits, chunk)
    base = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    before = torch.cumsum(hist, 0, dtype=torch.int32)
    return base + torch.cat([torch.zeros_like(before[:1]), before])


def radix_scatter_plain(keys: torch.Tensor, values: torch.Tensor,
                        offs: torch.Tensor, shift: int, bits: int = BITS,
                        chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``radix_scatter``, given the chunk
    offsets (``chunk_offsets_plain``): digit by digit, the rank of a key
    among its chunk's keys of that digit is a prefix sum of the digit's
    mask along the chunk, as the TPU kernel takes it; one ``index_copy_``
    then places keys and rows. No sort is involved."""
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


def _state_words(c: int, bits: int) -> int:
    """64-bit words of one scatter's scratch: the ticket counter and one
    descriptor a (chunk, digit)."""
    return 1 + -(-c // CHUNK) * (1 << bits)


_SCRATCH_WORDS = 1 << 16  # the least allocation
_scratch_of = {}          # (device index, stream) -> int64 tensor


def _scratch(words: int, device, stream: int) -> torch.Tensor:
    """At least ``words`` 64-bit words of scratch for the stream. The C entry
    points clear what a sort uses on the stream before its first launch, and
    launches on one stream run in turn, so one allocation a stream serves
    every call; it is replaced, never resized, when a longer sort comes."""
    key = (device.index, stream)
    scratch = _scratch_of.get(key)
    if scratch is None or scratch.numel() < words:
        scratch = torch.empty(max(words, _SCRATCH_WORDS), dtype=torch.int64, device=device)
        _scratch_of[key] = scratch
    return scratch


def _launch_scatter(keys: torch.Tensor, values: torch.Tensor, counts: int,
                    state: int, clear_bytes: int, shift: int, bits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    out_k, out_v = torch.empty_like(keys), torch.empty_like(values)
    build.check("radix_scatter", _library().gs_radix_scatter(
        keys.data_ptr(), values.data_ptr(), values.shape[0], keys.shape[0], shift,
        bits, counts, state, clear_bytes, out_k.data_ptr(), out_v.data_ptr(),
        build.stream_ptr()))
    if keys.shape[0]:
        radix_scatter.launches += 1
    return out_k, out_v


def radix_scatter(keys: torch.Tensor, values: torch.Tensor, counts: torch.Tensor,
                  shift: int, bits: int = BITS
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable pass: key i of chunk c with digit d goes to slot (keys of
    any digit below d) + (digit-d keys of the chunks before c) + (keys of c
    before i with digit d), and column i of ``values`` (nv, C) int32 goes
    with it. ``counts`` (2^bits,) int32 is this pass's row of
    ``radix_counts``. Returns (keys, values) in the new order. On CUDA
    tensors one clear and one launch; the chunks' bases are integer sums,
    so the result repeats bit for bit."""
    _check_digit(shift, bits)
    c = keys.shape[0]
    build.expect("radix_scatter keys", keys, torch.int32, (c,))
    build.expect("radix_scatter values", values, torch.int32, (None, c))
    build.expect("radix_scatter counts", counts, torch.int32, (1 << bits,))
    if not build.on_cuda("radix_scatter", keys, values, counts):
        return radix_scatter_plain(
            keys, values, chunk_offsets_plain(keys, counts, shift, bits, CHUNK),
            shift, bits, CHUNK)
    words = _state_words(c, bits)
    state = _scratch(words, keys.device, build.stream_ptr())
    return _launch_scatter(keys, values, counts.data_ptr(), state.data_ptr(),
                           8 * words, shift, bits)


radix_counts.launches = 0
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
    tensors). Exact and stable: equal keys keep their input order. On CUDA
    tensors ``radix_counts`` once and ``radix_scatter`` a pass, behind one
    clear of the sort's scratch (its counts and every pass's tickets and
    descriptors).
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
    passes = passes_of(key_bits, bits)
    if not build.on_cuda("radix_sort", k, v):
        counts = radix_counts(k, key_bits, bits)
        for p in range(passes):
            k, v = radix_scatter(k, v, counts[p], p * bits, bits)
    elif k.shape[0]:
        # one scratch area: the (passes, 2^bits) counts, then each pass's
        # ticket and descriptors; the count's entry point clears all of it
        K, state = 1 << bits, _state_words(k.shape[0], bits)
        head = -(-passes * K // 2)
        scratch = _scratch(head + passes * state, k.device, build.stream_ptr())
        at = scratch.data_ptr()
        _launch_counts(k, passes, bits, at, at, 8 * (head + passes * state))
        for p in range(passes):
            k, v = _launch_scatter(k, v, at + 4 * K * p, at + 8 * (head + p * state),
                                   0, p * bits, bits)
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
        with span("gs.sort.bwd"):
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
