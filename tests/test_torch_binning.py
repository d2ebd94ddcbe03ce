"""The port's oracle binning and sorting (``ops/binning.py``,
``ops/sorting.py``) against a Python-loop oracle and the JAX package.

Mirrors ``tests/test_binning.py``, with every record array also held to
the JAX package's ``expand_records`` / ``sort_and_bin`` exactly, and the
sorts held to ``jax.lax.sort``'s order on ties, -0.0 and +inf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.ops import binning as jax_binning
from openglgaussiansplattingrenderer_tpu.ops import sorting as jax_sorting

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import binning, sorting


def _loop_expand(counts, tile_min, tile_ext, depth, gx):
    """The reference's per-splat duplication loop (preprocess.glsl:171-189),
    row-major over the overlapped tile rectangle."""
    recs = []
    for i in range(len(counts)):
        for j in range(counts[i]):
            tx = tile_min[i, 0] + j % tile_ext[i, 0]
            ty = tile_min[i, 1] + j // tile_ext[i, 0]
            recs.append((i, ty * gx + tx, depth[i]))
    return recs


def _random_prep(rng, n, gx=16, gy=16):
    tmin = np.stack([rng.integers(0, gx, n), rng.integers(0, gy, n)], axis=1).astype(np.int32)
    ext = np.stack(
        [np.minimum(rng.integers(1, 4, n), gx - tmin[:, 0]),
         np.minimum(rng.integers(1, 4, n), gy - tmin[:, 1])], axis=1
    ).astype(np.int32)
    counts = (ext[:, 0] * ext[:, 1]).astype(np.int32)
    counts[rng.random(n) < 0.2] = 0
    depth = rng.random(n).astype(np.float32)
    return counts, tmin, ext, depth


def _both(prep, opts, capacity):
    """(port records as numpy, JAX records as numpy)."""
    got = binning.expand_records(*map(torch.as_tensor, prep), RenderConfig(**opts),
                                 capacity)
    want = jax_binning.expand_records(*map(jnp.asarray, prep), JaxConfig(**opts),
                                      capacity)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _assert_equal_records(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_expand_matches_loop():
    rng = np.random.default_rng(1234)
    opts = dict(dup_capacity_factor=6.0)
    n = 200
    prep = _random_prep(rng, n)
    capacity = RenderConfig(**opts).capacity(n)
    recs, want_j = _both(prep, opts, capacity)
    _assert_equal_records(recs, want_j)
    counts, tmin, ext, depth = prep
    want = _loop_expand(counts, tmin, ext, depth, 16)
    total = int(recs["total"])
    assert total == len(want) and total <= capacity
    got = list(zip(recs["splat_id"][:total], recs["tile"][:total], recs["depth"][:total]))
    assert [(int(a), int(b)) for a, b, _ in got] == [(a, b) for a, b, _ in want]
    np.testing.assert_array_equal([d for _, _, d in got], [d for _, _, d in want])
    # padding is flagged invalid with the sentinel tile and +inf depth
    assert np.all(recs["tile"][total:] == 256)
    assert np.all(np.isinf(recs["depth"][total:])) and not recs["valid"][total:].any()
    assert int(recs["overflow"]) == 0


def test_overflow_is_dropped_and_counted():
    rng = np.random.default_rng(1234)
    opts = dict(dup_capacity_factor=1.0, chunk=16)
    n = 64
    counts, tmin, ext, depth = _random_prep(rng, n)
    counts = np.maximum(counts, 1).astype(np.int32)  # force records
    capacity = RenderConfig(**opts).capacity(n)
    recs, want = _both((counts, tmin, ext, depth), opts, capacity)
    _assert_equal_records(recs, want)
    assert int(recs["overflow"]) == max(int(counts.sum()) - capacity, 0) > 0
    assert recs["tile"].shape == (capacity,)


@pytest.mark.parametrize("depth_key", ["pair", "reference"])
def test_sort_and_bin_ranges(depth_key):
    rng = np.random.default_rng(99)
    opts = dict(dup_capacity_factor=8.0, depth_key=depth_key)
    n = 500
    prep = _random_prep(rng, n)
    counts, tmin, ext, depth = prep
    if depth_key == "reference":
        # keep tile + depth inside the float budget (QUIRKS.md)
        depth = (depth * 0.9).astype(np.float32)
        prep = (counts, tmin, ext, depth)
    cfg = RenderConfig(**opts)
    recs = binning.expand_records(*map(torch.as_tensor, prep), cfg, cfg.capacity(n))
    sorted_sid, bounds = binning.sort_and_bin(recs, cfg)
    jcfg = JaxConfig(**opts)
    jrecs = jax_binning.expand_records(*map(jnp.asarray, prep), jcfg, cfg.capacity(n))
    jsid, jbounds = jax_binning.sort_and_bin(jrecs, jcfg)
    np.testing.assert_array_equal(sorted_sid.numpy(), np.asarray(jsid))
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(jbounds))
    stats = {k: v.item() for k, v in binning.bin_stats(bounds).items()}
    assert stats == {k: np.asarray(v).item()
                     for k, v in jax_binning.bin_stats(jbounds).items()}

    bounds, sorted_sid = bounds.numpy(), sorted_sid.numpy()
    total = int(recs["total"])
    assert bounds[0] == 0 and bounds[-1] == total
    assert np.all(np.diff(bounds) >= 0)
    by_tile = {}
    for sid, tile, _ in _loop_expand(counts, tmin, ext, depth, cfg.grid_x):
        by_tile.setdefault(tile, []).append(sid)
    for t in range(cfg.num_tiles):
        seg = sorted_sid[bounds[t]:bounds[t + 1]]
        assert np.all(np.diff(depth[seg]) >= 0), f"tile {t} not depth sorted"
        assert sorted(seg.tolist()) == sorted(by_tile.get(t, []))


SORT_CASES = {
    # equal keys keep their input order; -0.0 and +0.0 are equal keys
    "ties and signed zeros": (
        [3, 1, 1, 3, 0, 1, 1, 0, 2, 2],
        [0.5, -0.0, 0.0, 0.5, 0.25, 0.0, -0.0, 0.25, 0.75, 0.75]),
    # invalid records: the sentinel tile with +inf depth, after the valid ones
    "sentinel and +inf": (
        [4, 1, 4, 0, 1, 4, 0, 2],
        [np.inf, 0.5, np.inf, -0.0, 0.5, np.inf, 0.0, np.inf]),
    "random with repeats": (
        np.random.default_rng(3).integers(0, 5, 64),
        np.random.default_rng(4).choice([0.0, -0.0, 0.125, 0.5, np.inf], 64)),
}


@pytest.mark.parametrize("case", list(SORT_CASES))
def test_sorts_match_lax_sort(case):
    tile, depth = SORT_CASES[case]
    tile = np.asarray(tile, np.int32)
    depth = np.asarray(depth, np.float32)
    values = np.arange(tile.size, dtype=np.int32)
    tt, td, tv = map(torch.as_tensor, (tile, depth, values))
    jt, jd, jv = map(jnp.asarray, (tile, depth, values))
    for port_sort, jax_sort in ((sorting.sort_by_tile_depth, jax_sorting.sort_by_tile_depth),
                                (sorting.sort_by_float_key, jax_sorting.sort_by_float_key)):
        got_t, got_v = port_sort(tt, td, tv)
        want_t, want_v = jax_sort(jt, jd, jv)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # a non-finite packed key maps to tile 2**30, as in JAX
    assert (sorting.sort_by_float_key(tt, td, tv)[0].numpy() == 2 ** 30).sum() == (
        np.isinf(depth).sum())
    got = sorting.argsort_floats(td)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sorting.argsort_floats(jd)))
    # lax.sort's own order: stable with -0.0 == +0.0
    _, lax_order = jax.lax.sort((jd, jv), num_keys=1, is_stable=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lax_order))


def test_reference_key_mode_matches_pair_mode():
    """The packed float key groups as the pair key where depths fit its
    float budget (depths kept below 0.9: QUIRKS.md)."""
    rng = np.random.default_rng(42)
    n = 300
    counts, tmin, ext, depth = _random_prep(rng, n)
    depth = (depth * 0.9).astype(np.float32)
    cfg_pair = RenderConfig(depth_key="pair", dup_capacity_factor=8.0)
    cfg_ref = RenderConfig(depth_key="reference", dup_capacity_factor=8.0)
    recs = binning.expand_records(*map(torch.as_tensor, (counts, tmin, ext, depth)),
                                  cfg_pair, cfg_pair.capacity(n))
    sid_a, bounds_a = binning.sort_and_bin(recs, cfg_pair)
    sid_b, bounds_b = binning.sort_and_bin(recs, cfg_ref)
    assert torch.equal(bounds_a, bounds_b)
    ba = bounds_a.numpy()
    for t in range(cfg_pair.num_tiles):
        np.testing.assert_array_equal(np.sort(sid_a.numpy()[ba[t]:ba[t + 1]]),
                                      np.sort(sid_b.numpy()[ba[t]:ba[t + 1]]))
