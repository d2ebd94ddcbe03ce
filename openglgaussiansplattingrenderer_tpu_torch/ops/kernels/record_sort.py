"""The record sort stage: the stable (tile, depth) sort of the records with
their nine fields, the per-tile bounds, and the un-sort of the cotangents.

Counterpart of the JAX fast path's record sort: the payload ``lax.sort``
of ``records.sort_multi_with_payload((tile, depth), fields)`` for the
default pair key and of ``records.sort_with_payload`` for the packed key
(``ops/fastpath.py:322``, ``ops/pallas/records.py:212-282`` there), then
``jnp.searchsorted`` for the bounds; the backward re-sorts the cotangents
by the source index (``_sort_cotangents``). XLA compiles all of it there.
Here, on CUDA tensors:

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
- then one row gather (``gs_record_gather``, ``csrc/record_gather.cu``)
  of the nine field rows by the sorted source index, a field row at a
  time. A sort of p passes is 2 + p launches, counted in
  ``record_sort.launches`` (eight at the flagship's 512 tiles for the pair
  key, six for the packed);
- the backward, the un-sort, is the same row gather of the nine cotangent
  rows by the inverse, with the bf16 cotangent mode's rounding
  (``records.BWD_COT_PACK``): one launch, counted in
  ``record_unsort.launches``.

The key words are u32 held as int32 bit patterns, written by the expansion
kernel (``records.expand(..., key=)``, ``records.sort_word``): for the
pair key (lo, hi) = (the depth's order-kept bits, the tile id), the two
halves of ``records.pair_key``; for the packed key one word,
``records.packed_key``. Every tile id lies in [0, num_tiles].

On CPU tensors the stage runs its plain version, ``record_sort_plain``:
the int64 key, ``torch.sort(stable=True)``, one ``index_select`` and
``searchsorted`` (and one ``index_copy_`` back), what the port ran before
the kernels. ``record_sort_passes_plain`` restates the kernels' algorithm
in plain torch (the passes of ``radix_sort``'s plain versions, the gather
after the last pass, the bounds from the tile counts); the
``record_sort="radix"`` route takes it on the CPU. A stable sort has one
answer: the kernels, both plain versions and the JAX sorts agree bit for
bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr

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


def record_sort_plain(fields: torch.Tensor, words: Sequence[torch.Tensor],
                      num_tiles: int, key: str):
    """The stage's plain version, what the port ran before the kernels: the
    int64 key, ``torch.sort(stable=True)``, the fields gathered by one
    ``index_select``, ``searchsorted`` of the tile boundaries. Returns
    (sorted fields (9, C), bounds (T+1,) int32, sorted source index int64)."""
    sk, si = torch.sort(key64(words, key), stable=True)
    shift = 32 if key == "pair" else kr.PACKED_DEPTH_BITS
    bnd = torch.arange(num_tiles + 1, dtype=torch.int64, device=sk.device) << shift
    return (fields.index_select(1, si),
            torch.searchsorted(sk, bnd, right=False).to(torch.int32), si)


def record_sort_passes_plain(fields: torch.Tensor, words: Sequence[torch.Tensor],
                             num_tiles: int, key: str):
    """The kernels' algorithm in plain torch: the counts of every pass and
    of every tile, then ``radix_sort.radix_scatter_plain`` a pass over
    ``radix_sort.CHUNK``-key chunks (the low word carrying the high word
    and the source index, then the high word carrying the index), the
    fields gathered by the sorted index after the last pass, the bounds
    from the tile counts. Returns what ``record_sort_plain`` does, the index
    int32."""
    c = fields.shape[1]
    idx = torch.arange(c, dtype=torch.int32, device=fields.device)
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
    si = v[-1]
    return (fields.index_select(1, si), tile_bounds_plain(tile_of(words, key), num_tiles),
            si)


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


def _check(fields: torch.Tensor, words: Sequence[torch.Tensor], num_tiles: int,
           key: str) -> None:
    if key not in KEYS:
        raise ValueError(f"record_sort: key must be one of {KEYS}, got {key!r}")
    c = fields.shape[1]
    build.expect("record_sort fields", fields, torch.float32, (kr.NUM_FIELDS, c))
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


def record_sort_fwd(fields: torch.Tensor, words: Sequence[torch.Tensor],
                    num_tiles: int, key: str, passes_model: bool = False,
                    inverse: bool = True):
    """The stage's forward alone: on CUDA tensors the kernels, on CPU
    tensors ``record_sort_plain`` (``record_sort_passes_plain`` with
    ``passes_model``). Returns (sorted fields (9, C), bounds (T+1,) int32,
    the order the un-sort takes: on CUDA the inverse of the sorted source
    index, int32, or None where ``inverse`` is False (its scattered stores
    are left out: a frame without a gradient needs no un-sort); on the CPU
    the index itself)."""
    _check(fields, words, num_tiles, key)
    if not build.on_cuda("record_sort", fields, *words, has_backward=True):
        plain = record_sort_passes_plain if passes_model else record_sort_plain
        return plain(fields, words, num_tiles, key)
    c, dev = fields.shape[1], fields.device
    bins = num_tiles + 1
    bounds = torch.empty(bins, dtype=torch.int32, device=dev)
    si = torch.empty(c, dtype=torch.int32, device=dev)
    inv = torch.empty(c, dtype=torch.int32, device=dev) if inverse else None
    if c == 0:
        return torch.empty_like(fields), bounds.zero_(), inv
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
    record_sort.launches += 1
    k, rows, iota = words[0], (None if hi is None else hi[None]), 1
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
        record_sort.launches += 1
        k, rows, iota = out_k, out_v, 0
    sf = _gather(fields, si, 0, "record_sort gather")
    record_sort.launches += 1
    return sf, bounds, inv


def record_unsort(g: torch.Tensor, order: torch.Tensor,
                  paired_rows: Optional[int] = None) -> torch.Tensor:
    """The un-sort: (9, C) cotangents of the sorted records back in source
    order, ``order`` what ``record_sort_fwd`` returned. Under the bf16
    cotangent mode the first ``paired_rows`` rows (default 8) are rounded to
    bfloat16 first. On CUDA tensors one launch of the row gather by the
    inverse; on CPU tensors ``unsort_plain`` by the index. Every element is
    written once: the result repeats bit for bit."""
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


class RecordSort(torch.autograd.Function):
    """``record_sort_fwd`` with ``record_unsort`` as its gradient with
    respect to the fields; the key words and the bounds carry none."""

    @staticmethod
    def forward(ctx, fields, lo, hi, num_tiles, key, passes_model, inverse):
        words = (lo,) if hi is None else (lo, hi)
        sf, bounds, order = record_sort_fwd(fields, words, num_tiles, key, passes_model,
                                            inverse=inverse)
        ctx.save_for_backward(order)
        ctx.mark_non_differentiable(bounds)
        return sf, bounds

    @staticmethod
    def backward(ctx, g_sf, _g_bounds):
        (order,) = ctx.saved_tensors
        return (record_unsort(g_sf.contiguous(), order),) + (None,) * 6


def record_sort(fields: torch.Tensor, words: Sequence[torch.Tensor], num_tiles: int,
                key: str, passes_model: bool = False):
    """Stable (tile, depth) sort of the records (``fields`` (9, C), key
    ``words`` from ``words_of``) and the per-tile bounds. Returns (sorted
    fields (9, C), differentiable with respect to ``fields``; bounds (T+1,)
    int32). ``passes_model`` picks ``record_sort_passes_plain`` as the
    plain version on CPU tensors; CUDA tensors run the kernels either way."""
    hi = words[1] if len(words) > 1 else None
    # the un-sort's inverse index only where a gradient can flow back
    inverse = torch.is_grad_enabled() and fields.requires_grad
    return RecordSort.apply(fields, words[0], hi, num_tiles, key, passes_model, inverse)


record_sort.launches = 0
record_unsort.launches = 0
