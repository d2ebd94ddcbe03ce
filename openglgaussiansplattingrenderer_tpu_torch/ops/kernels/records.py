"""Record expansion, its transpose, and the record sort.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/pallas/records.py``:
the duplicate expansion (kernel ``csrc/expand.cu``), whose gradient is the
per-splat segment sum of the record cotangents (kernel ``csrc/segsum.cu``),
joined by ``Expand``, a ``torch.autograd.Function``; and the stable payload
sort, which is ``torch.sort(stable=True)`` on the key plus one gather of
the fields -- the JAX package's ``SORT_MODE="gather"`` form, proven
bit-identical to its payload sort. Its gradient scatters the cotangents
back by the recorded source index. The same sort on the radix-sort kernels
is ``radix_sort.radix_sort_with_payload``; the frame's default record sort
is the stage of ``record_sort.py``, on the sort words the expansion writes
(``expand(..., key=)``, ``sort_word``). Also here: the record sort keys
(``pair_key``, ``packed_key`` and its u32 form) and the q16 inference mode,
which sorts the nine fields packed into five u32 words
(``sort_records_q16``; plain torch, as it is plain ``jnp`` in the JAX
package).

Records are kept as a (9, C) float32 field array (mx, my, A, B, C, op, r,
g, b), an int32 tile id per record (``num_tiles`` marks an invalid record)
and a float32 depth per record.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

NUM_FIELDS = 9
# Merged items (records and splat ends) a piece of the partition of the
# expansion and the segment sum holds: ``kItems`` of
# ``csrc/records_common.cuh``.
PARTITION_ITEMS = 1024


@functools.lru_cache(maxsize=1)
def _library():
    """The kernel library, once its partition size is checked against
    ``PARTITION_ITEMS``, which sizes the segment sum's carry slots."""
    lib = build.load_library()
    if lib.gs_records_items() != PARTITION_ITEMS:
        raise RuntimeError(f"records: the kernels partition by "
                           f"{lib.gs_records_items()} items, PARTITION_ITEMS "
                           f"says {PARTITION_ITEMS}")
    return lib


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _ln_alpha_min(alpha_min: float) -> float:
    # the TPU kernel subtracts ln(alpha_min) rounded to float32
    return float(np.float32(np.log(alpha_min)))


# The record sort's keys (``fastpath.sort_records``): the expansion writes
# one u32 word a record for them, 1 for the pair key's low word, 2 for the
# packed key (``sort_word``); 0 writes none.
KEY_MODES = {None: 0, "pair": 1, "packed": 2}


def expand_plain(fields, tile_min, tile_ext, depth, cum_incl, *, capacity,
                 gx, num_tiles, pw, ph, alpha_min, key=None):
    """The plain PyTorch version of ``expand``: a searchsorted gather and
    the same cull arithmetic, in the same order; with ``key``, the sort
    word of each record from its tile and depth (``sort_word``)."""
    dev = fields.device
    n = fields.shape[1]
    r = torch.arange(capacity, dtype=torch.int32, device=dev)
    if n == 0:
        out = (torch.zeros((NUM_FIELDS, capacity), dtype=torch.float32, device=dev),
               torch.full((capacity,), num_tiles, dtype=torch.int32, device=dev),
               torch.zeros(capacity, dtype=torch.float32, device=dev))
        return out if key is None else out + (sort_word(out[1], out[2], key),)
    total = torch.clamp_max(cum_incl[-1], capacity)
    s = torch.searchsorted(cum_incl, r, right=True).clamp_max(n - 1)
    cum_excl = torch.cat([cum_incl.new_zeros(1), cum_incl[:-1]])
    j = r - cum_excl[s]
    ext = tile_ext[s, 0].clamp_min(1)
    q = torch.div(j, ext, rounding_mode="floor")
    ty = tile_min[s, 1] + q
    tx = tile_min[s, 0] + (j - q * ext)
    f = fields[:, s]

    mx, my, aa, bb, cc, op = f[0], f[1], f[2], f[3], f[4], f[5]
    x0 = tx.to(torch.float32) * float(pw)
    y0 = ty.to(torch.float32) * float(ph)
    dx0 = torch.clamp(mx, x0, x0 + (pw - 1)) - mx
    dy0 = torch.clamp(my, y0, y0 + (ph - 1)) - my
    ylo = y0 - my
    xlo = x0 - mx
    dys = torch.clamp(-bb * dx0 / torch.clamp_min(cc, 1e-12), ylo, ylo + (ph - 1))
    q1 = (aa * dx0 * dx0 + cc * dys * dys) + 2.0 * (bb * dx0 * dys)
    dxs = torch.clamp(-bb * dy0 / torch.clamp_min(aa, 1e-12), xlo, xlo + (pw - 1))
    q2 = (aa * dxs * dxs + cc * dy0 * dy0) + 2.0 * (bb * dxs * dy0)
    qmin = torch.minimum(q1, q2)
    ln_ratio = torch.log(torch.clamp_min(op, 1e-30)) - _ln_alpha_min(alpha_min)

    valid = r < total
    keep = valid & (qmin * 0.49999 <= ln_ratio + 1e-4)
    tile = torch.where(keep, ty * gx + tx, torch.full_like(ty, num_tiles))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = (torch.where(valid[None, :], f, zero), tile.to(torch.int32),
           torch.where(valid, depth[s], zero))
    return out if key is None else out + (sort_word(out[1], out[2], key),)


def expand_fwd(fields, tile_min, tile_ext, depth, cum_incl, *, capacity, gx,
               num_tiles, pw, ph, alpha_min, key=None):
    """The expansion alone (no autograd graph): the CUDA kernel for CUDA
    tensors, ``expand_plain`` for CPU tensors."""
    n = fields.shape[1]
    build.expect("expand fields", fields, torch.float32, (NUM_FIELDS, n))
    build.expect("expand tile_min", tile_min, torch.int32, (n, 2))
    build.expect("expand tile_ext", tile_ext, torch.int32, (n, 2))
    build.expect("expand depth", depth, torch.float32, (n,))
    build.expect("expand cum_incl", cum_incl, torch.int32, (n,))
    if capacity >= 2 ** 31:
        raise ValueError(f"expand: capacity {capacity} exceeds int32 indices")
    if key not in KEY_MODES:
        raise ValueError(f"expand: key must be one of {tuple(KEY_MODES)}, got {key!r}")
    args = dict(capacity=capacity, gx=gx, num_tiles=num_tiles, pw=pw, ph=ph,
                alpha_min=alpha_min, key=key)
    if not build.on_cuda("expand", fields, tile_min, tile_ext, depth, cum_incl):
        return expand_plain(fields, tile_min, tile_ext, depth, cum_incl, **args)
    dev = fields.device
    out_f = torch.empty((NUM_FIELDS, capacity), dtype=torch.float32, device=dev)
    out_t = torch.empty(capacity, dtype=torch.int32, device=dev)
    out_d = torch.empty(capacity, dtype=torch.float32, device=dev)
    out_k = None if key is None else torch.empty(capacity, dtype=torch.int32, device=dev)
    lib = _library()
    build.check("expand", lib.gs_expand(
        fields.data_ptr(), tile_min.data_ptr(), tile_ext.data_ptr(),
        depth.data_ptr(), cum_incl.data_ptr(), n, out_f.data_ptr(),
        out_t.data_ptr(), out_d.data_ptr(), None if out_k is None else out_k.data_ptr(),
        capacity, gx, num_tiles, pw, ph, _ln_alpha_min(alpha_min), KEY_MODES[key],
        build.stream_ptr()))
    expand.launches += 1
    return (out_f, out_t, out_d) if out_k is None else (out_f, out_t, out_d, out_k)


def segsum_plain(g: torch.Tensor, cum_incl: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``segsum``: each record's splat by
    ``searchsorted`` and one ``index_add_`` over the records below total."""
    n, c = cum_incl.shape[0], g.shape[1]
    out = torch.zeros((g.shape[0], n), dtype=g.dtype, device=g.device)
    if n == 0 or c == 0:
        return out
    r = torch.arange(c, dtype=torch.int32, device=g.device)
    valid = torch.nonzero(r < torch.clamp_max(cum_incl[-1], c)).squeeze(1)
    s = torch.searchsorted(cum_incl, r[valid], right=True)
    return out.index_add_(1, s, g[:, valid])


def segsum(g: torch.Tensor, cum_incl: torch.Tensor) -> torch.Tensor:
    """Transpose of the expansion: ``out[:, s]`` is the sum of the record
    cotangents ``g`` (9, C) over splat s's span [cum_excl[s], min(cum_incl[s],
    total)), total = min(cum_incl[-1], C); zero for a splat with no
    records. The kernel sums in a fixed order, so the result is the same
    from run to run. On CUDA tensors it takes two launches (the sums of
    each piece of the partition, then the carries of the splats cut between
    pieces), both counted in ``segsum.launches``. Returns (9, N) float32."""
    n = cum_incl.shape[0]
    build.expect("segsum g", g, torch.float32, (NUM_FIELDS, None))
    build.expect("segsum cum_incl", cum_incl, torch.int32, (n,))
    if not build.on_cuda("segsum", g, cum_incl):
        return segsum_plain(g, cum_incl)
    out = torch.empty((NUM_FIELDS, n), dtype=torch.float32, device=g.device)
    if n == 0:
        return out
    c = g.shape[1]
    lib = _library()
    # a carry (9 floats) and a first-end splat (int32) for each piece of
    # the n splat ends and c records
    pieces = -(-(n + c) // PARTITION_ITEMS)
    scratch = torch.empty(10 * pieces, dtype=torch.float32, device=g.device)
    build.check("segsum", lib.gs_segsum(
        g.data_ptr(), c, cum_incl.data_ptr(), n, out.data_ptr(),
        scratch.data_ptr(), build.stream_ptr()))
    segsum.launches += 2     # the sums, then the carries of cut splats
    return out


class Expand(torch.autograd.Function):
    """``expand_fwd`` with ``segsum`` as its gradient with respect to the
    splat fields. The tile ids, depths and sort words of the records, and
    the integer inputs, carry no gradient (sort keys are not
    differentiated)."""

    @staticmethod
    def forward(ctx, fields, tile_min, tile_ext, depth, cum_incl, capacity,
                gx, num_tiles, pw, ph, alpha_min, key):
        out = expand_fwd(
            fields, tile_min, tile_ext, depth, cum_incl, capacity=capacity,
            gx=gx, num_tiles=num_tiles, pw=pw, ph=ph, alpha_min=alpha_min, key=key)
        ctx.save_for_backward(cum_incl)
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_fields, *_g_keys):
        (cum_incl,) = ctx.saved_tensors
        return (segsum(g_fields.contiguous(), cum_incl),) + (None,) * 11


def expand(fields: torch.Tensor, tile_min: torch.Tensor, tile_ext: torch.Tensor,
           depth: torch.Tensor, cum_incl: torch.Tensor, *, capacity: int, gx: int,
           num_tiles: int, pw: int, ph: int, alpha_min: float,
           key: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """Splat-major records from the per-splat table.

    Record r belongs to splat s with cum_excl[s] <= r < cum_incl[s]; it
    carries that splat's 9 ``fields`` (9, N), its tile (tile_min (N, 2),
    tile_ext (N, 2), row-major over the splat's tile rect) and its
    ``depth`` (N,). Records at or past total = min(cum_incl[-1], capacity)
    are zero with tile ``num_tiles``, and so is the tile of a record whose
    Gaussian cannot reach ``alpha_min`` anywhere in its pw x ph tile.
    Returns (fields (9, C) f32, tile (C,) int32, depth (C,) f32); the
    fields are differentiable with respect to ``fields``. With ``key``
    ("pair" or "packed") a fourth output, (C,) int32: each record's sort
    word (``sort_word``), written by the kernel from the record it holds.
    ``expand.launches`` counts launches of the expansion kernel,
    ``segsum.launches`` those of its transpose.
    """
    return Expand.apply(fields, tile_min, tile_ext, depth, cum_incl, capacity,
                        gx, num_tiles, pw, ph, alpha_min, key)


expand.launches = 0
segsum.launches = 0


# Backward cotangent precision through the un-sort (the JAX package's
# ``BWD_COT_PACK``, ``records.py:159-204`` there): "bf16" rounds the field
# cotangents in pairs, rows (0, 1), (2, 3), ... to bfloat16 (round to
# nearest even, as ``astype(bfloat16)`` does) before they go back to source
# order; an odd last row stays float32. The JAX package packs each pair into
# one u32 operand of its sort, which is where its time went; here the
# rounding alone is kept, so the gradients equal the JAX package's in that
# mode. Opt-in (not bit-equal to f32): set GS_BWD_SORT=bf16 before import,
# or set this flag, which ``SortWithPayload.backward`` reads at each call.
# The radix sort's backward does not use it, as in the JAX package.
BWD_COT_PACK = os.environ.get("GS_BWD_SORT", "f32")


def round_cotangent_pairs(g: torch.Tensor, paired_rows: Optional[int] = None
                          ) -> torch.Tensor:
    """The bf16 mode's rounding of (F, C) cotangents: the first
    ``paired_rows`` rows (default the even part of F) to bfloat16 and back,
    the rest untouched."""
    k = g.shape[0] // 2 * 2 if paired_rows is None else paired_rows
    if k == 0:
        return g
    return torch.cat([g[:k].to(torch.bfloat16).to(g.dtype), g[k:]])


class SortWithPayload(torch.autograd.Function):
    """Stable sort of the key with the fields gathered along; the backward
    puts the field cotangents back in source order. ``si`` is a full
    permutation, so that is one scatter without collisions (the same
    result from run to run); the key gets no gradient."""

    @staticmethod
    def forward(ctx, key, fields, paired_rows):
        sk, si = torch.sort(key, stable=True)
        ctx.save_for_backward(si)
        ctx.paired_rows = paired_rows
        ctx.mark_non_differentiable(sk, si)
        return sk, si, fields.index_select(1, si)

    @staticmethod
    def backward(ctx, _g_key, _g_idx, g_fields):
        (si,) = ctx.saved_tensors
        if BWD_COT_PACK == "bf16":
            g_fields = round_cotangent_pairs(g_fields, ctx.paired_rows)
        return (None, torch.empty_like(g_fields).index_copy_(1, si, g_fields),
                None)


def sort_with_payload(key: torch.Tensor, fields: torch.Tensor,
                      paired_rows: Optional[int] = None):
    """Stable sort by ``key``; returns (sorted_key, source_idx,
    sorted_fields) with ``fields`` (F, C) gathered along the record axis,
    differentiable with respect to ``fields``. ``paired_rows`` is how many
    leading rows the bf16 cotangent mode rounds (``round_cotangent_pairs``;
    default the even part of F)."""
    return SortWithPayload.apply(key, fields, paired_rows)


def pair_key(tile: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """One int64 key whose order is the lexicographic (tile, depth) order
    of the JAX package's ``sort_multi_with_payload((tile, depth), ...)``:
    tile in the high 32 bits, the float's bits mapped to an order-keeping
    unsigned integer in the low 32 (negative floats have their bits
    inverted, non-negative ones their sign bit set)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits + (1 << 31), -1 - bits)
    return (tile.to(torch.int64) << 32) + ordered


PACKED_DEPTH_BITS = 22              # the packed key's quantised depth


def tile_key_bits(num_tiles: int) -> int:
    """Bits of a tile id in 0..num_tiles (num_tiles is the invalid tile)."""
    return max(1, int(num_tiles).bit_length())


def packed_key_bits(num_tiles: int) -> int:
    """Bits of ``packed_key`` over ``num_tiles`` tiles: the tile id above
    the quantised depth."""
    return PACKED_DEPTH_BITS + tile_key_bits(num_tiles)


def packed_key(tile: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """tile * 2^22 + 22-bit quantised depth, the ``depth_key="packed"``
    key (held in int64; at most 512 tiles keep it below 2^32)."""
    q = 1 << PACKED_DEPTH_BITS
    qd = torch.clamp_max((depth.clamp(0.0, 1.0) * float(q)).to(torch.int64), q - 1)
    return tile.to(torch.int64) * q + qd


def depth_order_bits(depth: torch.Tensor) -> torch.Tensor:
    """``pair_key``'s low 32 bits as int32 bit patterns: the float's bits
    with the sign bit set where it was clear and every bit inverted where
    it was set, so that unsigned order is float order."""
    bits = depth.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits | -(1 << 31), ~bits)


def sort_word(tile: torch.Tensor, depth: torch.Tensor, key: str) -> torch.Tensor:
    """The record sort's word of each record, as int32 bit patterns: for
    ``"pair"`` the pair key's low word (``depth_order_bits``; its high word
    is the tile id), for ``"packed"`` the packed key (``packed_key_u32``).
    What ``expand(..., key=)`` writes."""
    if key == "pair":
        return depth_order_bits(depth)
    if key == "packed":
        return packed_key_u32(tile, depth)
    raise ValueError(f"sort_word: key must be 'pair' or 'packed', got {key!r}")


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same 32 bits
    (PyTorch has little uint32 arithmetic, so u32 words are held so)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def u32_values(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``u32_bits``: int32 bit patterns -> int64 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def packed_key_u32(tile: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """``packed_key`` as u32 bit patterns in int32, the radix sort's key
    type (the invalid tile 512 sets the top bit)."""
    return u32_bits(packed_key(tile, depth))


# ---------------------------------------------------------------------------
# quantized-payload record sort (the "q16" inference precision mode)
# ---------------------------------------------------------------------------
# Inference does not need bit-exact f32 fields, so this mode packs the 9
# fields into five u32 words before the sort and unpacks them after:
#
#   w0 = mx:24-bit fixed over [-wp, 2*wp)  | opacity[15:8]
#   w1 = my:24-bit fixed over [-hp, 2*hp)  | opacity[7:0]
#   w2 = conic A (f16) << 16 | conic B (f16)
#   w3 = conic C (f16) << 16 | red   (f16)
#   w4 = green   (f16) << 16 | blue  (f16)
#
# The words equal the JAX package's bit for bit: the same float32
# expression order, round-half-to-even, and float16 casts that round to
# nearest even. The word arithmetic runs in int64 (a shift of an int32
# that holds a u32 would smear its sign) and the words are stored as int32
# bit patterns. Means outside [-wp, 2*wp) x [-hp, 2*hp) clamp to the range
# edge. INFERENCE ONLY: round and clamp are flat almost everywhere, so the
# backward of ``sort_records_q16`` raises instead of returning zeros.

_Q16_POS_BITS = 24


def q16_pack(fields: torch.Tensor, wp: int, hp: int) -> torch.Tensor:
    """(9, C) float32 fields -> (5, C) int32 words (u32 bit patterns)."""
    mx, my, a, b, c, op, r, g, bl = fields
    m = (1 << _Q16_POS_BITS) - 1

    def fix24(x, lo, hi):
        s = float(m) / (hi - lo)
        return torch.clamp(torch.round((x - lo) * s), 0.0, float(m)).to(torch.int64)

    def f16(x):
        return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF

    opq = torch.clamp(torch.round(op * 65535.0), 0.0, 65535.0).to(torch.int64)
    return u32_bits(torch.stack([
        fix24(mx, -wp, 2.0 * wp) * 256 + (opq >> 8),
        fix24(my, -hp, 2.0 * hp) * 256 + (opq & 255),
        f16(a) * 65536 + f16(b),
        f16(c) * 65536 + f16(r),
        f16(g) * 65536 + f16(bl)]))


def q16_unpack(words: torch.Tensor, wp: int, hp: int) -> torch.Tensor:
    """(5, C) int32 words -> (9, C) float32 fields."""
    w0, w1, w2, w3, w4 = u32_values(words)
    m = (1 << _Q16_POS_BITS) - 1

    def unfix24(q, lo, hi):
        s = (hi - lo) / float(m)
        return q.to(torch.float32) * s + lo

    def unf16(q):
        # 16 bits in int64 -> the int16 with those bits -> float16
        return (q - ((q >> 15) << 16)).to(torch.int16).view(torch.float16).to(
            torch.float32)

    op = ((w0 & 255) * 256 + (w1 & 255)).to(torch.float32) / 65535.0
    return torch.stack([
        unfix24(w0 >> 8, -wp, 2.0 * wp), unfix24(w1 >> 8, -hp, 2.0 * hp),
        unf16(w2 >> 16), unf16(w2 & 0xFFFF), unf16(w3 >> 16), op,
        unf16(w3 & 0xFFFF), unf16(w4 >> 16), unf16(w4 & 0xFFFF)])


class SortRecordsQ16(torch.autograd.Function):
    """Float fields in, float fields out, so that the guard spans the
    integer region: autograd prunes a function of integer words from the
    graph, and a guard inside it would never run."""

    @staticmethod
    def forward(ctx, key, fields, wp, hp):
        sk, si = torch.sort(key, stable=True)
        ctx.mark_non_differentiable(sk)
        return sk, q16_unpack(q16_pack(fields, wp, hp).index_select(1, si), wp, hp)

    @staticmethod
    def backward(ctx, _g_key, _g_fields):
        raise NotImplementedError(
            "sort_payload='q16' is an inference-only precision mode: the "
            "quantized record sort has no useful gradient (round/clamp are "
            "flat a.e.). Train with sort_payload='f32'.")


def sort_records_q16(key: torch.Tensor, fields: torch.Tensor, wp: int, hp: int):
    """Stable single-key record sort with the 9 fields packed to 5 u32
    words (see the q16 block comment): the sort moves the key and a source
    index, one gather moves the (5, C) words. Returns (sorted_key, unpacked
    sorted fields (9, C)). ``wp``/``hp`` are the padded image dims (the
    fixed-point position range). Inference-only: differentiating through it
    raises."""
    if fields.shape[0] != NUM_FIELDS:
        raise ValueError(f"q16 sort packs exactly {NUM_FIELDS} fields, "
                         f"got {fields.shape[0]}")
    return SortRecordsQ16.apply(key, fields, wp, hp)
