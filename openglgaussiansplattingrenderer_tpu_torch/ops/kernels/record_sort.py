"""The record sort stage: the stable (tile, depth) sort of the records with
their nine fields, the per-tile bounds, and the un-sort of the cotangents.

Counterpart of the JAX fast path's record sort: the payload ``lax.sort``
of ``records.sort_multi_with_payload((tile, depth), fields)`` for the
default pair key and of ``records.sort_with_payload`` for the packed key
(``ops/fastpath.py:322``, ``ops/pallas/records.py:212-282`` there), then
``jnp.searchsorted`` for the bounds; the backward re-sorts the cotangents
by the source index (``_sort_cotangents``). XLA compiles all of it there.

A record's nine fields are a copy of its splat's, so the expansion writes
each record's splat id in their place (``records.expand_ids``) and the
stage gathers the sorted records' fields by splat. On CUDA tensors:

- one launch (``gs_record_counts``, ``csrc/radix_sort.cu``) clears the
  stage's scratch, counts every pass's 8-bit digits of the key words and
  the records of each tile, and its last block turns the tile counts into
  ``bounds``: bounds[k] is the number of records whose tile is below k,
  what ``searchsorted`` of the sorted keys gives;
- then kernel 7 (``radix_scatter``, ``gs_record_scatter``) once a pass, a
  stable least-significant-digit sort: the pair key's low word first, its
  passes carrying (high word, source index), then its high word, the tile
  id, carrying the index; the packed key's passes carry the index. The
  first pass makes the index itself, and the last pass stores no key: it
  writes the sorted source index and, where the fields need a gradient,
  for each record it places the index's inverse (inv[source] = slot),
  which the backward takes;
- then one launch writes the sorted records' splat ids (``gs_id_gather``)
  and one reads their fields from the splat table's pair layout
  (``gs_pair_gather``, ``csrc/record_gather.cu``): 3 + p launches for p
  passes, counted in ``record_sort_splats.launches`` (nine at the
  flagship's 512 tiles for the pair key, seven for the packed). A frame
  without a gradient needs no inverse, so its passes carry the splat ids
  in place of the source index and the ids' gather is left out;
- the backward, the un-sort, gathers the sorted records' nine cotangent
  rows by the inverse (``gs_record_gather``), with the bf16 cotangent
  mode's rounding (``records.BWD_COT_PACK``): one launch, counted in
  ``record_unsort.launches``; then ``records.segsum`` sums them by splat.

The key words are u32 held as int32 bit patterns, written by the expansion
kernel (``records.expand_ids``, ``records.sort_word``): for the pair key
(lo, hi) = (the depth's order-kept bits, the tile id), the two halves of
``records.pair_key``; for the packed key one word, ``records.packed_key``.
Every tile id lies in [0, num_tiles].

On CPU tensors the stage runs its plain version,
``record_sort_splats_plain``: the int64 key, ``torch.sort(stable=True)``,
``index_select`` and ``searchsorted`` (and one ``index_copy_`` back), what
the port ran before the kernels; ``record_sort_plain`` is the same stage
on the records' own fields. ``sort_order_passes_plain`` restates the
kernels' algorithm in plain torch (the passes of ``radix_sort``'s plain
versions, the bounds from the tile counts); the ``record_sort="radix"``
route takes it on the CPU. A stable sort has one answer: the kernels, both
plain versions and the JAX sorts agree bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt
from openglgaussiansplattingrenderer_tpu_torch.utils.timing import span

KEYS = ("pair", "packed")
DIGIT_BITS = 8          # the kernels' digit width
DIGITS = 1 << DIGIT_BITS


def words_of(tile: torch.Tensor, depth: torch.Tensor, key: str,
             word: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The records' key words: (lo, tile) for ``"pair"``, (word,) for
    ``"packed"``; ``word`` is the expansion's sort word where it wrote one,
    else it is built here (``records.sort_word``)."""
    lo = kr.sort_word(tile, depth, key) if word is None else word
    return (lo, tile) if key == "pair" else (lo,)


def key_bits(num_tiles: int, key: str) -> Tuple[int, int]:
    """Significant bits of the low and the high word (0: no high word)."""
    if key == "pair":
        return 32, kr.tile_key_bits(num_tiles)
    return kr.packed_key_bits(num_tiles), 0


def passes(num_tiles: int, key: str) -> Tuple[int, int]:
    """8-bit passes over the low and over the high word."""
    lo_bits, hi_bits = key_bits(num_tiles, key)
    return (rx.passes_of(lo_bits, DIGIT_BITS),
            rx.passes_of(hi_bits, DIGIT_BITS) if hi_bits else 0)


def key64(words: Sequence[torch.Tensor], key: str) -> torch.Tensor:
    """The int64 key of the words: ``records.pair_key`` or
    ``records.packed_key``."""
    lo = kr.u32_values(words[0])
    return lo if key == "packed" else (words[1].to(torch.int64) << 32) + lo


def tile_of(words: Sequence[torch.Tensor], key: str) -> torch.Tensor:
    """Each record's tile id, from its key words."""
    if key == "pair":
        return words[1]
    return (words[0] >> kr.PACKED_DEPTH_BITS) & ((1 << (32 - kr.PACKED_DEPTH_BITS)) - 1)


def tile_bounds_plain(tile: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """(num_tiles + 1,) int32, entry k the records whose tile is below k:
    the exclusive prefix sum of the tile counts, as the counts launch's
    last block takes it."""
    hist = torch.bincount(tile, minlength=num_tiles + 1)[:num_tiles + 1]
    return (torch.cumsum(hist, 0) - hist).to(torch.int32)


def sort_order_plain(words: Sequence[torch.Tensor], num_tiles: int, key: str):
    """The stage's order in plain torch: the int64 key,
    ``torch.sort(stable=True)``, ``searchsorted`` of the tile boundaries.
    Returns (bounds (T+1,) int32, sorted source index int64)."""
    sk, si = torch.sort(key64(words, key), stable=True)
    shift = 32 if key == "pair" else kr.PACKED_DEPTH_BITS
    bnd = torch.arange(num_tiles + 1, dtype=torch.int64, device=sk.device) << shift
    return torch.searchsorted(sk, bnd, right=False).to(torch.int32), si


def record_sort_plain(fields: torch.Tensor, words: Sequence[torch.Tensor],
                      num_tiles: int, key: str):
    """The stage's plain version, what the port ran before the kernels:
    ``sort_order_plain`` and the fields gathered by one ``index_select``.
    Returns (sorted fields (9, C), bounds (T+1,) int32, sorted source index
    int64)."""
    bounds, si = sort_order_plain(words, num_tiles, key)
    return fields.index_select(1, si), bounds, si


def sort_order_passes_plain(words: Sequence[torch.Tensor], num_tiles: int, key: str):
    """The kernels' order in plain torch: the counts of every pass and of
    every tile, then ``radix_sort.radix_scatter_plain`` a pass over
    ``radix_sort.CHUNK``-key chunks (the low word carrying the high word
    and the source index, then the high word carrying the index), the
    bounds from the tile counts. Returns what ``sort_order_plain`` does,
    the index int32."""
    c = words[0].shape[0]
    idx = torch.arange(c, dtype=torch.int32, device=words[0].device)
    lo_bits, hi_bits = key_bits(num_tiles, key)

    def lsd(k, v, nbits):
        counts = rx.radix_counts_plain(k, nbits, DIGIT_BITS)
        for p in range(rx.passes_of(nbits, DIGIT_BITS)):
            shift = p * DIGIT_BITS
            offs = rx.chunk_offsets_plain(k, counts[p], shift, DIGIT_BITS, rx.CHUNK)
            k, v = rx.radix_scatter_plain(k, v, offs, shift, DIGIT_BITS, rx.CHUNK)
        return k, v

    if key == "pair":
        _, v = lsd(words[0], torch.stack([words[1], idx]), lo_bits)
        _, v = lsd(v[0].contiguous(), v[1:].contiguous(), hi_bits)
    else:
        _, v = lsd(words[0], idx[None], lo_bits)
    return tile_bounds_plain(tile_of(words, key), num_tiles), v[-1]


def inverse_plain(si: torch.Tensor) -> torch.Tensor:
    """The inverse permutation: inv[si[j]] = j, int32."""
    inv = torch.empty(si.shape[0], dtype=torch.int32, device=si.device)
    inv[si.to(torch.int64)] = torch.arange(si.shape[0], dtype=torch.int32,
                                           device=si.device)
    return inv


def _paired(paired_rows: Optional[int]) -> int:
    """Rows the un-sort rounds to bfloat16 now: none unless
    ``records.BWD_COT_PACK`` is "bf16", read at each call."""
    if kr.BWD_COT_PACK != "bf16":
        return 0
    return kr.NUM_FIELDS // 2 * 2 if paired_rows is None else paired_rows


def _gather(x: torch.Tensor, idx: torch.Tensor, paired: int, what: str) -> torch.Tensor:
    """The row gather kernel: out[r, j] = x[r, idx[j]], rows below
    ``paired`` rounded to bfloat16. One launch, not counted here."""
    out = torch.empty_like(x)
    build.check(what, rx._library().gs_record_gather(
        x.data_ptr(), idx.data_ptr(), x.shape[1], paired, out.data_ptr(),
        build.stream_ptr()))
    return out


def unsort_plain(g: torch.Tensor, si: torch.Tensor, paired: int = 0) -> torch.Tensor:
    """The un-sort's plain version, the port's backward before the kernel:
    the first ``paired`` rows rounded to bfloat16 and back
    (``records.round_cotangent_pairs``), then one ``index_copy_`` by the
    sorted source index."""
    if paired:
        g = kr.round_cotangent_pairs(g, paired)
    return torch.empty_like(g).index_copy_(1, si.to(torch.int64), g)


def unsort_gather_plain(g: torch.Tensor, inv: torch.Tensor, paired: int = 0) -> torch.Tensor:
    """The un-sort's gather form in plain torch: out[:, i] = g[:, inv[i]]."""
    if paired:
        g = kr.round_cotangent_pairs(g, paired)
    return g.index_select(1, inv.to(torch.int64))


def _check_words(words: Sequence[torch.Tensor], num_tiles: int, key: str, c: int) -> None:
    if key not in KEYS:
        raise ValueError(f"record_sort: key must be one of {KEYS}, got {key!r}")
    if len(words) != (2 if key == "pair" else 1):
        raise ValueError(f"record_sort: the {key} key has "
                         f"{2 if key == 'pair' else 1} words, got {len(words)}")
    for w in words:
        build.expect("record_sort words", w, torch.int32, (c,))
    if key == "packed" and kr.packed_key_bits(num_tiles) > 32:
        raise ValueError(f"record_sort: the packed key holds at most 512 tiles, "
                         f"got {num_tiles}")
    if c >= 2 ** 31:
        raise ValueError(f"record_sort: {c} records exceed int32 indices")


def _two_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2, C) rows ``a``, ``b``: a view where ``b`` follows ``a`` in one
    buffer (``records.expand_ids`` lays out the tile ids and the splat ids
    so), else a copy."""
    c = a.shape[0]
    if (b.data_ptr() == a.data_ptr() + a.element_size() * c
            and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()):
        return a.as_strided((2, c), (c, 1))
    return torch.stack([a, b])


def _order(words: Sequence[torch.Tensor], num_tiles: int, key: str, inverse: bool,
           counter, payload: Optional[torch.Tensor] = None) -> tuple:
    """The kernels' order: the counts launch, then a scatter a pass, each
    counted in ``counter.launches``. The passes carry the source index,
    which the first one makes, or ``payload`` (C,) int32 in its place (no
    inverse then). Returns (the sorted source index or the sorted payload,
    bounds, the inverse index or None), int32."""
    if inverse and payload is not None:
        raise ValueError("record_sort: the inverse needs the source index as the payload")
    c, dev = words[0].shape[0], words[0].device
    bins = num_tiles + 1
    bounds = torch.empty(bins, dtype=torch.int32, device=dev)
    si = torch.empty(c, dtype=torch.int32, device=dev)
    inv = torch.empty(c, dtype=torch.int32, device=dev) if inverse else None
    if c == 0:
        return si, bounds.zero_(), inv
    lo_p, hi_p = passes(num_tiles, key)
    n_pass = lo_p + hi_p
    # one scratch area, cleared by the counts launch: the (passes, 256)
    # digit counts, the tile counts and the last-block ticket (int32), then
    # each pass's ticket and chunk descriptors (64-bit words)
    state = rx._state_words(c, DIGIT_BITS)
    head = -(-(n_pass * DIGITS + bins + 1) // 2)
    stream = build.stream_ptr()
    at = rx._scratch(head + n_pass * state, dev, stream).data_ptr()
    lib = rx._library()
    hi = words[1] if key == "pair" else None
    build.check("record_sort counts", lib.gs_record_counts(
        words[0].data_ptr(), None if hi is None else hi.data_ptr(), c, lo_p, hi_p,
        kr.PACKED_DEPTH_BITS, bins, at, at + 4 * n_pass * DIGITS,
        at + 4 * (n_pass * DIGITS + bins), bounds.data_ptr(), at,
        8 * (head + n_pass * state), stream))
    counter.launches += 1
    if payload is None:
        k, rows, iota = words[0], (None if hi is None else hi[None]), 1
    else:
        k, iota = words[0], 0
        rows = payload[None] if hi is None else _two_rows(hi, payload)
    for j in range(n_pass):
        if j == lo_p:          # the high word's passes: it is the key now
            k, rows = rows[0], rows[1:]
        last = j == n_pass - 1
        nv = 0 if rows is None else rows.shape[0]
        out_k = None if last else torch.empty(c, dtype=torch.int32, device=dev)
        out_v = si[None] if last else torch.empty((nv + iota, c), dtype=torch.int32,
                                                  device=dev)
        shift = (j if j < lo_p else j - lo_p) * DIGIT_BITS
        build.check("record_sort scatter", lib.gs_record_scatter(
            k.data_ptr(), None if rows is None else rows.data_ptr(), nv, iota, c, shift,
            at + 4 * DIGITS * j, at + 8 * (head + j * state),
            None if out_k is None else out_k.data_ptr(), out_v.data_ptr(),
            inv.data_ptr() if last and inverse else None, stream))
        counter.launches += 1
        k, rows, iota = out_k, out_v, 0
    return si, bounds, inv


def record_unsort(g: torch.Tensor, order: torch.Tensor,
                  paired_rows: Optional[int] = None) -> torch.Tensor:
    """The un-sort: (9, C) cotangents of the sorted records back in source
    order, ``order`` what ``record_sort_splats_fwd`` returned. Under the
    bf16 cotangent mode the first ``paired_rows`` rows (default 8) are
    rounded to bfloat16 first. On CUDA tensors one launch of the row gather
    by the inverse; on CPU tensors ``unsort_plain`` by the index. Every
    element is written once: the result repeats bit for bit."""
    paired = _paired(paired_rows)
    c = g.shape[1]
    build.expect("record_unsort g", g, torch.float32, (kr.NUM_FIELDS, c))
    if not build.on_cuda("record_unsort", g, order):
        return unsort_plain(g, order, paired)
    build.expect("record_unsort order", order, torch.int32, (c,))
    out = _gather(g, order, paired, "record_unsort")
    if c:
        record_unsort.launches += 1
    return out


def fields_of_splats_plain(fields: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The fields (9, C) of splats ``ids`` in [0, N] in plain torch, zero
    for id N: what the pair gather reads."""
    padded = torch.cat([fields, fields.new_zeros((kr.NUM_FIELDS, 1))], 1)
    return padded.index_select(1, ids.to(torch.int64))


def _id_gather(splat_ids: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """The sorted records' splat ids, splat_ids[si] (``gs_id_gather``). One
    launch, not counted here."""
    out = torch.empty_like(si)
    build.check("record_sort ids", rx._library().gs_id_gather(
        splat_ids.data_ptr(), si.data_ptr(), si.shape[0], out.data_ptr(),
        build.stream_ptr()))
    return out


def _pair_gather(pairs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The fields (9, C) of splats ``ids`` from the pair layout
    (``gs_pair_gather``). One launch, not counted here."""
    c = ids.shape[0]
    out = torch.empty((kr.NUM_FIELDS, c), dtype=torch.float32, device=ids.device)
    build.check("record_sort gather", rx._library().gs_pair_gather(
        pairs.data_ptr(), pairs.shape[0] // kt.PAIR_LAYOUT_ROWS, ids.data_ptr(), c,
        out.data_ptr(), build.stream_ptr()))
    return out


def _check_splats(fields, pairs, splat_ids, words, num_tiles, key) -> None:
    n = fields.shape[1]
    build.expect("record_sort fields", fields, torch.float32, (kr.NUM_FIELDS, n))
    build.expect("record_sort pairs", pairs, torch.float32,
                 (kt.PAIR_LAYOUT_ROWS * (n + 1),))
    build.expect("record_sort splat_ids", splat_ids, torch.int32, (None,))
    _check_words(words, num_tiles, key, splat_ids.shape[0])


def record_sort_splats_plain(fields: torch.Tensor, splat_ids: torch.Tensor,
                             words: Sequence[torch.Tensor], num_tiles: int, key: str,
                             passes_model: bool = False):
    """The stage in plain torch: ``sort_order_plain``
    (``sort_order_passes_plain`` with ``passes_model``), then the fields of
    the sorted records' splats (``fields_of_splats_plain``). Returns
    (sorted fields (9, C), bounds, sorted source index): what
    ``record_sort_plain`` returns for the records' fields."""
    order = sort_order_passes_plain if passes_model else sort_order_plain
    bounds, si = order(words, num_tiles, key)
    sid = splat_ids.index_select(0, si.to(torch.int64))
    return fields_of_splats_plain(fields, sid), bounds, si


def record_sort_splats_fwd(fields: torch.Tensor, pairs: torch.Tensor,
                           splat_ids: torch.Tensor, words: Sequence[torch.Tensor],
                           num_tiles: int, key: str, passes_model: bool = False,
                           inverse: bool = True):
    """The stage's forward alone: the splat fields (9, N) and their pair
    layout (``table.splat_pairs_plain``, which the splat table kernel
    stores with ``pairs=True``), the records' splat ids (C,) in [0, N]
    (``records.expand_ids``) and their key words. On CUDA tensors the
    counts launch, a scatter a pass, the sorted records' splat ids
    (``gs_id_gather``; where no inverse is asked for, the passes carry the
    splat ids in place of the source index and this launch is left out)
    and their fields (``gs_pair_gather``); on CPU tensors
    ``record_sort_splats_plain`` (``passes_model`` as there). Returns
    (sorted fields (9, C), bounds (T+1,) int32, the order the un-sort
    takes: on CUDA the inverse of the sorted source index, int32, or None
    where ``inverse`` is False; on the CPU the index itself): for the
    records' fields (9, C) = fields[:, splat_ids] (zero for id N), what
    ``record_sort_plain`` returns, bit for bit."""
    _check_splats(fields, pairs, splat_ids, words, num_tiles, key)
    if not build.on_cuda("record_sort", fields, pairs, splat_ids, *words,
                         has_backward=True):
        return record_sort_splats_plain(fields, splat_ids, words, num_tiles, key,
                                        passes_model)
    if inverse:
        si, bounds, inv = _order(words, num_tiles, key, True, record_sort_splats)
        ids = _id_gather(splat_ids, si)
    else:     # no un-sort: the passes carry the splat ids themselves
        ids, bounds, inv = _order(words, num_tiles, key, False, record_sort_splats,
                                  payload=splat_ids)
    sf = _pair_gather(pairs, ids)
    if splat_ids.shape[0]:
        record_sort_splats.launches += 2 if inverse else 1
    return sf, bounds, inv


class RecordSortSplats(torch.autograd.Function):
    """``record_sort_splats_fwd``; its gradient with respect to the splat
    fields is ``record_unsort`` followed by ``records.segsum``. The pair
    layout, the splat ids, the key words and the bounds carry none."""

    @staticmethod
    def forward(ctx, fields, pairs, splat_ids, lo, hi, cum_incl, num_tiles, key,
                passes_model, inverse):
        words = (lo,) if hi is None else (lo, hi)
        sf, bounds, order = record_sort_splats_fwd(fields, pairs, splat_ids, words,
                                                   num_tiles, key, passes_model,
                                                   inverse=inverse)
        ctx.save_for_backward(order, cum_incl)
        ctx.mark_non_differentiable(bounds)
        return sf, bounds

    @staticmethod
    def backward(ctx, g_sf, _g_bounds):
        order, cum_incl = ctx.saved_tensors
        with span("gs.sort.bwd"):
            g = record_unsort(g_sf.contiguous(), order)
        return (kr.segsum(g, cum_incl),) + (None,) * 9


def record_sort_splats(fields: torch.Tensor, pairs: torch.Tensor, splat_ids: torch.Tensor,
                       words: Sequence[torch.Tensor], num_tiles: int, key: str,
                       cum_incl: torch.Tensor, passes_model: bool = False):
    """Stable (tile, depth) sort of the records given by splat: ``fields``
    (9, N) the splat table's and ``pairs`` their pair layout, which it
    stored, ``splat_ids`` (C,) each record's splat from
    ``records.expand_ids``, ``words`` its key words, ``cum_incl`` the
    inclusive prefix sum of the splats' record counts. Returns (sorted
    fields (9, C), differentiable with respect to ``fields``; bounds (T+1,)
    int32): what ``records.expand`` followed by the stable sort of its
    fields (``record_sort_plain``) returns, bit for bit, and so is the
    gradient (``records.segsum`` of the un-sorted cotangents, ``Expand``'s).
    ``record_sort_splats.launches`` counts the stage's forward launches: 3
    + the passes, 2 + the passes where no gradient can flow."""
    hi = words[1] if len(words) > 1 else None
    # the un-sort's inverse index only where a gradient can flow back
    inverse = torch.is_grad_enabled() and fields.requires_grad
    return RecordSortSplats.apply(fields, pairs, splat_ids, words[0], hi, cum_incl,
                                  num_tiles, key, passes_model, inverse)


class SplatFields(torch.autograd.Function):
    """The records' fields by splat, unsorted; the gradient is
    ``records.segsum``."""

    @staticmethod
    def forward(ctx, fields, pairs, splat_ids, cum_incl):
        ctx.save_for_backward(cum_incl)
        if not build.on_cuda("splat_fields", fields, pairs, splat_ids, has_backward=True):
            return fields_of_splats_plain(fields, splat_ids)
        out = _pair_gather(pairs, splat_ids)
        if splat_ids.shape[0]:
            splat_fields.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (cum_incl,) = ctx.saved_tensors
        return kr.segsum(g.contiguous(), cum_incl), None, None, None


def splat_fields(fields: torch.Tensor, pairs: torch.Tensor, splat_ids: torch.Tensor,
                 cum_incl: torch.Tensor) -> torch.Tensor:
    """The records' (9, C) fields from the splat fields (9, N), their pair
    layout (``table.splat_pairs_plain``) and the records' splat ids
    (``records.expand_ids``): what ``records.expand`` returns as its
    fields, bit for bit and with its gradient (``records.segsum``). On CUDA
    tensors one launch of the pair gather, counted in
    ``splat_fields.launches``."""
    n = fields.shape[1]
    build.expect("splat_fields fields", fields, torch.float32, (kr.NUM_FIELDS, n))
    build.expect("splat_fields pairs", pairs, torch.float32, (kt.PAIR_LAYOUT_ROWS * (n + 1),))
    build.expect("splat_fields splat_ids", splat_ids, torch.int32, (None,))
    return SplatFields.apply(fields, pairs, splat_ids, cum_incl)


record_unsort.launches = 0
record_sort_splats.launches = 0
splat_fields.launches = 0
