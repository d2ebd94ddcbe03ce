"""The load-balanced partition of records and splats that the expansion and
the segment sum kernels share (``csrc/records_common.cuh``), modelled here
in numpy step for step as the kernels take it, and held to the plain
PyTorch versions on the CPU:

- the warp's 32-probe merge-path search finds the same split as a plain
  search on every diagonal;
- every record and every splat end falls in exactly one block's piece, and
  no piece holds more than K items;
- the expansion built from the pieces (window, groups of four records, the
  search of the window) equals ``expand_plain`` exactly;
- the segment sum built from the pieces (threads walking their items, the
  segmented scan of their open sums, the carries of cut splats) is within
  1e-6 of ``segsum_plain`` of each row's scale, empty splats exactly zero,
  and the carries reach each cut splat once.

The counts are the shapes the kernels must survive: a run of empty splats
longer than several pieces at the start, in the middle and at the end (the
hoisted table's shape), a splat of 2,040 records (a 1080p tile grid),
``total == capacity``, ``total > capacity``, one splat, and a capacity that
is not a multiple of 4. ``test_torch_cuda.py`` runs the kernels on the same
cases.
"""

import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr

CASES = ["zeros_start", "zeros_middle", "zeros_end", "large_splat",
         "total_is_capacity", "overflow", "one_splat", "capacity_not_x4"]
# (K, items a segment-sum thread walks): the kernels' own, and small pieces
# that cut the same counts into many pieces
PIECES = [(kr.PARTITION_ITEMS, 4), (64, 8), (12, 3)]
GX, GY, PW, PH = 64, 300, 16, 16


def partition_case(name, k=kr.PARTITION_ITEMS, seed=0):
    """(counts int32 (n,), capacity) of one named case; empty runs are
    longer than three pieces of ``k`` items."""
    rng = np.random.default_rng(seed + len(name))
    run = 3 * k + 5
    body = rng.integers(0, 6, 400)
    if name == "zeros_start":
        counts = np.concatenate([np.zeros(run, np.int64), body])
    elif name == "zeros_middle":
        counts = np.concatenate([body[:200], np.zeros(run, np.int64), body[200:]])
    elif name == "zeros_end":
        counts = np.concatenate([body, np.zeros(run, np.int64)])
    elif name == "large_splat":
        counts = body.copy()
        counts[150] = 2040
    elif name == "one_splat":
        counts = np.array([37])
    else:
        counts = body
    total = int(counts.sum())
    capacity = {"total_is_capacity": total, "overflow": (total - 333) // 4 * 4,
                "one_splat": 40,
                "capacity_not_x4": total + 7 + (total % 4 == 1)}.get(
                    name, -(-(total + 12) // 4) * 4)
    return counts.astype(np.int32), capacity


def splat_table(counts, seed=0):
    """A splat table whose tile rects hold each splat's count: fields (9, n),
    tile_min (n, 2), tile_ext (n, 2), depth (n,), as numpy arrays."""
    rng = np.random.default_rng(seed)
    n = counts.shape[0]
    ext_x = rng.integers(1, 9, n)
    ext_y = np.maximum(-(-counts // ext_x), 1)
    tile_min = np.stack([rng.integers(0, GX - 8, n), rng.integers(0, 40, n)], 1)
    fields = np.stack([
        (tile_min[:, 0] + rng.random(n) * ext_x) * PW,
        (tile_min[:, 1] + rng.random(n) * ext_y) * PH,
        0.001 + rng.random(n) * 0.3, (rng.random(n) - 0.5) * 0.01,
        0.001 + rng.random(n) * 0.3, 0.01 + rng.random(n) * 0.98,
        rng.random(n) * 255, rng.random(n) * 255, rng.random(n) * 255])
    return (fields.astype(np.float32), tile_min.astype(np.int32),
            np.stack([ext_x, ext_y], 1).astype(np.int32),
            rng.random(n).astype(np.float32))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _setup(cum, capacity):
    n = cum.shape[0]
    total = min(int(cum[-1]), capacity) if n else 0
    ends = np.minimum(cum.astype(np.int64), total)              # E[s]
    return n, total, ends + np.arange(n)                        # end positions


def plain_search(end_pos, d, n, total):
    """The ends among the first d merged items."""
    lo, hi = max(0, d - total), min(d, n)
    return lo + int(np.searchsorted(end_pos[lo:hi], d, side="left"))


def warp_search(end_pos, d, n, total, lanes=32):
    """``warp_merge_search`` of records_common.cuh, one list entry a lane."""
    lo, hi = max(0, d - total), min(d, n)
    while hi - lo > lanes:
        step = (hi - lo + lanes - 1) // lanes
        past = [p >= hi or end_pos[p] >= d for p in (lo + l * step for l in range(lanes))]
        if not any(past):
            lo = lo + (lanes - 1) * step + 1
            continue
        j = past.index(True)
        if j == 0:
            return lo
        lo, hi = lo + (j - 1) * step + 1, min(hi, lo + j * step)
    past = [lo + l < hi and end_pos[lo + l] >= d for l in range(lanes)]
    return lo + past.index(True) if any(past) else hi


def pieces(cum, capacity, k):
    """Each block's (s0, s1, r0, r1): ends [s0, s1), records [r0, r1)."""
    n, total, end_pos = _setup(cum, capacity)
    merged = n + total
    out = []
    for d0 in range(0, merged, k):
        d1 = min(d0 + k, merged)
        s0, s1 = warp_search(end_pos, d0, n, total), warp_search(end_pos, d1, n, total)
        out.append((s0, s1, d0 - s0, d1 - s1))
    return out


def window_search(cum_w, lo, hi, r):
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if cum_w[mid] <= r:
            lo = mid
        else:
            hi = mid
    return lo


def model_expand_splats(cum, capacity, k, threads=256):
    """Each record's splat as the expansion kernel finds it (-1 at or past
    total), and how many times each record was written."""
    n, total, _ = _setup(cum, capacity)
    splat = np.full(capacity, -1, np.int64)
    written = np.zeros(capacity, np.int64)
    blocks = -(-(n + capacity) // k)
    got = pieces(cum, capacity, k)
    for b in range(blocks):
        d0, d1 = b * k, min(b * k + k, n + capacity)
        if b < len(got):
            s0, s1, r0, r1 = got[b]
            if r1 > r0:
                nw = min(s1, n - 1) - s0 + 1
                cum_w = np.concatenate([[cum[s0 - 1] if s0 else 0], cum[s0:s0 + nw]])
                for t in range(threads):
                    i = 0
                    for g in range((r0 >> 2) + t, ((r1 - 1) >> 2) + 1, threads):
                        for r in range(4 * g, 4 * g + 4):
                            if r0 <= r < r1:
                                if cum_w[i + 1] <= r:
                                    i = window_search(cum_w, i + 1, nw, r)
                                splat[r] = s0 + i
                                written[r] += 1
        for item in range(max(d0, n + total), d1):              # the tail
            written[item - n] += 1
    return splat, written


def model_expand(fields, tile_min, tile_ext, depth, cum, capacity, k):
    """The records as the expansion kernel builds them, in float32."""
    splat, written = model_expand_splats(cum, capacity, k)
    assert (written == 1).all(), "a record written other than once"
    valid = splat >= 0
    s = np.where(valid, splat, 0)
    cum_excl = np.concatenate([[0], cum[:-1]]).astype(np.int64)
    j = np.arange(capacity) - cum_excl[s]
    ext = np.maximum(tile_ext[s, 0], 1)
    q = j // ext
    ty, tx = tile_min[s, 1] + q, tile_min[s, 0] + (j - q * ext)
    f = fields[:, s]
    mx, my, aa, bb, cc, op = f[:6]
    one = np.float32
    x0, y0 = tx.astype(one) * one(PW), ty.astype(one) * one(PH)
    dx0 = np.clip(mx, x0, x0 + one(PW - 1)) - mx
    dy0 = np.clip(my, y0, y0 + one(PH - 1)) - my
    ylo, xlo = y0 - my, x0 - mx
    dys = np.clip(-bb * dx0 / np.maximum(cc, one(1e-12)), ylo, ylo + one(PH - 1))
    q1 = (aa * dx0 * dx0 + cc * dys * dys) + one(2) * (bb * dx0 * dys)
    dxs = np.clip(-bb * dy0 / np.maximum(aa, one(1e-12)), xlo, xlo + one(PW - 1))
    q2 = (aa * dxs * dxs + cc * dy0 * dy0) + one(2) * (bb * dxs * dy0)
    ln_ratio = (torch.log(torch.from_numpy(np.maximum(op, one(1e-30)))).numpy()
                - one(kr._ln_alpha_min(1 / 255)))
    keep = valid & (np.minimum(q1, q2) * one(0.49999) <= ln_ratio + one(1e-4))
    tile = np.where(keep, ty * GX + tx, GX * GY).astype(np.int32)
    return (np.where(valid[None], f, one(0)), tile,
            np.where(valid, depth[s], one(0)))


def model_segsum(g, cum, k, per):
    """The segment sum as the kernels take it. Returns (out (9, n), the
    blocks whose carries reached each splat, the pieces)."""
    c = g.shape[1]
    n, total, _ = _setup(cum, c)
    ends = np.minimum(cum.astype(np.int64), total)
    got = pieces(cum, c, k)
    out = np.full((9, n), np.nan, np.float32)
    carry = np.zeros((len(got), 9), np.float32)
    first = np.full(len(got), -1)
    seen = np.zeros(n + total, np.int64)                        # items walked
    for b, (s0, s1, r0, r1) in enumerate(got):
        nends, nrec = s1 - s0, r1 - r0
        length = nends + nrec
        opens, closed, heads = [], [], []
        for dt in range(0, k, per):
            i = 0
            if dt < length:
                lo, hi = max(0, dt - nrec), min(dt, nends)
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if mid + (ends[s0 + mid] - r0) >= dt:
                        hi = mid
                    else:
                        lo = mid + 1
                i = lo
            r = r0 + dt - i
            mine, head = np.zeros(9, np.float32), None
            for item in range(dt, min(dt + per, length)):
                seen[b * k + item] += 1
                if i < nends and ends[s0 + i] <= r:
                    if head is None:
                        head = (i, mine)
                    else:
                        assert np.isnan(out[0, s0 + i])
                        out[:, s0 + i] = mine
                    mine, i = np.zeros(9, np.float32), i + 1
                else:
                    mine = mine + g[:, r]
                    r += 1
            opens.append(mine)
            closed.append(head is not None)
            heads.append(head)
        run = np.zeros(9, np.float32)                           # segmented scan
        for mine, cl, head in zip(opens, closed, heads):
            if head is not None:
                assert np.isnan(out[0, s0 + head[0]])
                out[:, s0 + head[0]] = run + head[1]
            run = mine if cl else run + mine
        carry[b], first[b] = run, (s0 if nends else -1)
    reached = {}
    for b in range(1, len(got)):                                # the second launch
        if first[b] < 0:
            continue
        acc = np.zeros(9, np.float32)
        for kb in range(b - 1, -1, -1):
            acc = acc + carry[kb]
            reached.setdefault(int(first[b]), []).append(kb)
            if kb == 0 or first[kb] >= 0:
                break
        out[:, first[b]] += acc
    assert (seen == 1).all(), "an item walked other than once"
    return out, reached, got, carry


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [4, 32])
@pytest.mark.parametrize("name", CASES)
def test_warp_search_finds_the_plain_split(name, lanes):
    counts, capacity = partition_case(name, 64)
    cum = np.cumsum(counts).astype(np.int32)
    n, total, end_pos = _setup(cum, capacity)
    for d in range(0, n + total + 1, 1 if n + total < 4000 else 7):
        assert (warp_search(end_pos, d, n, total, lanes)
                == plain_search(end_pos, d, n, total)), d


@pytest.mark.parametrize("k,per", PIECES)
@pytest.mark.parametrize("name", CASES)
def test_pieces_cover_every_item_once(name, k, per):
    counts, capacity = partition_case(name, k)
    cum = np.cumsum(counts).astype(np.int32)
    n, total, _ = _setup(cum, capacity)
    got = pieces(cum, capacity, k)
    assert len(got) == -(-(n + total) // k)
    rec = np.zeros(total, np.int64)
    end = np.zeros(n, np.int64)
    ends = np.minimum(cum.astype(np.int64), total)
    for s0, s1, r0, r1 in got:
        assert 0 < (s1 - s0) + (r1 - r0) <= k
        end[s0:s1] += 1
        rec[r0:r1] += 1
        # every record of the piece belongs to a splat of its window
        for r in (r0, r1 - 1) if r1 > r0 else ():
            assert s0 <= int(np.searchsorted(ends, r, side="right")) <= min(s1, n - 1)
    assert (rec == 1).all() and (end == 1).all()
    if name.startswith("zeros"):                # pieces of ends only
        assert any(r1 == r0 for _, _, r0, r1 in got)
    if name == "large_splat":                   # one splat over 3+ pieces
        s = 150
        lo, hi = int(cum[s - 1]), int(cum[s])
        assert sum(1 for _, _, r0, r1 in got if r0 < hi and r1 > lo) >= 3


@pytest.mark.parametrize("k,per", PIECES)
@pytest.mark.parametrize("name", CASES)
def test_model_expansion_equals_expand_plain(name, k, per):
    counts, capacity = partition_case(name, k)
    fields, tile_min, tile_ext, depth = splat_table(counts, 1)
    cum = np.cumsum(counts).astype(np.int32)
    want = kr.expand_plain(
        *map(torch.from_numpy, (fields, tile_min, tile_ext, depth, cum)),
        capacity=capacity, gx=GX, num_tiles=GX * GY, pw=PW, ph=PH, alpha_min=1 / 255)
    got = model_expand(fields, tile_min, tile_ext, depth, cum, capacity, k)
    for name_, a, b in zip(("fields", "tile", "depth"), got, want):
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(a)), b), name_
    keep = want[1] < GX * GY
    assert 0 < int(keep.sum()) < min(int(cum[-1]), capacity) or name == "one_splat"


@pytest.mark.parametrize("k,per", PIECES)
@pytest.mark.parametrize("name", CASES)
def test_model_segsum_within_1e6_of_plain_and_carries_reach_once(name, k, per):
    counts, capacity = partition_case(name, k)
    cum = np.cumsum(counts).astype(np.int32)
    # multiples of 1/64 below 8 in magnitude: every partial sum of up to
    # 2,040 of them is exact in float32, so any summation order gives the
    # same bits and a record summed into the wrong splat, twice or not at
    # all cannot hide under the rounding of a reordered sum
    rng = np.random.default_rng(2)
    g = (rng.integers(-512, 513, (9, capacity)) / 64).astype(np.float32)
    want = kr.segsum_plain(torch.from_numpy(g), torch.from_numpy(cum)).numpy()
    got, reached, pcs, carry = model_segsum(g, cum, k, per)
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    assert float((np.abs(got - want) / scale).max()) <= 1e-6
    assert np.array_equal(got, want)
    assert not got[:, counts == 0].any()
    # the blocks holding a splat's records before the block of its end are
    # the carries it got, each once; any other carry it got was zero
    n, total, _ = _setup(cum, capacity)
    ends = np.minimum(cum.astype(np.int64), total)
    starts = np.concatenate([[0], ends[:-1]])
    for s in range(n):
        owner = next(b for b, (s0, s1, _, _) in enumerate(pcs) if s0 <= s < s1)
        holders = [b for b, (_, _, r0, r1) in enumerate(pcs)
                   if b < owner and r0 < ends[s] and r1 > starts[s]]
        got_from = reached.get(s, [])
        assert len(got_from) == len(set(got_from))
        assert set(holders) <= set(got_from), (s, holders, got_from)
        for b in set(got_from) - set(holders):
            assert not carry[b].any()
    if name == "large_splat":
        assert len(reached[150]) >= 2
