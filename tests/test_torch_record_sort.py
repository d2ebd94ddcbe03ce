"""The record sort stage (``ops/kernels/record_sort.py``) on the CPU.

On the CPU the stage runs its plain versions. ``record_sort_passes_plain``
restates the kernels' algorithm: the two-word least-significant-digit
passes of ``radix_counts_plain`` / ``radix_scatter_plain`` (the low word
carrying the high word and the source index, then the high word carrying
the index), the gather after the last pass, and the bounds from the tile
histogram; ``unsort_gather_plain`` is the kernels' un-sort, a gather by the
inverse index. A stable sort has one answer, so every case holds bit for
bit, with no tolerance, against:

- ``record_sort_plain``: ``torch.sort(stable=True)`` of the int64 key,
  ``index_select``, ``searchsorted``; and ``index_copy_`` back;
- the JAX package's ``sort_multi_with_payload((tile, depth), fields)``
  (pair) and ``sort_with_payload(packed key, fields)`` with
  ``jnp.searchsorted``, and their ``jax.vjp``, in both cotangent modes
  (``GS_BWD_SORT=bf16`` rounds the first eight rows to bfloat16).

The inputs are made with numpy from a seed: ties, -0.0 and +0.0, negative
depths, the invalid tile, record counts below one 4,096-key chunk and not a
multiple of it, 512 and 2,040 tiles. One difference from JAX is by design:
the port's pair key orders -0.0 before +0.0 (a total order, since the
port's first slice), where ``lax.sort`` holds them equal and keeps their
input order. No frame makes it: a record's depth is its visible splat's,
past the near plane, or +0.0 past the record total. So the JAX comparison
takes the same draws with -0.0 made +0.0, and
``test_negative_zero_is_the_one_difference_from_lax_sort`` pins the
difference. Last, ``render_fast`` at 20 splats and 64x64 against the JAX
fast path: the sorted fields and bounds of ``stop_after="sort2"`` bit for
bit, the pair frame within 1e-4 with every stat equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops import fastpath as jax_fastpath
from openglgaussiansplattingrenderer_tpu.ops.pallas import records as jax_records
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (key, tiles, records, depths): "mixed" draws from a few values, ties and
# both zeros among them; "uniform" from [0, 1), where the packed key's 22
# bits tie nearby depths
CASES = {
    "pair-512-below-a-chunk": ("pair", 512, 1000, "mixed"),
    "pair-512-ragged": ("pair", 512, 2 * rx.CHUNK + 37, "mixed"),
    "pair-2040-ragged": ("pair", 2040, 3 * rx.CHUNK - 5, "uniform"),
    "pair-512-one-chunk": ("pair", 512, rx.CHUNK, "uniform"),
    "packed-512-below-a-chunk": ("packed", 512, 999, "uniform"),
    "packed-512-ragged": ("packed", 512, 2 * rx.CHUNK + 41, "mixed"),
    "packed-100-ragged": ("packed", 100, rx.CHUNK + 3, "uniform"),
}
MIXED = np.array([-2.5, -1e-3, -0.0, 0.0, 1e-30, 0.25, 0.25, 0.5, 1.0, 3e8],
                 np.float32)


def _records(key, tiles, c, depths, seed=0):
    """tile (C,) int32 in [0, tiles], a fifth of them the invalid tile;
    depth (C,) float32; fields (9, C) float32."""
    rng = np.random.default_rng(seed)
    tile = rng.integers(0, tiles, c).astype(np.int32)
    tile[rng.random(c) < 0.2] = tiles
    # runs of one tile, as a splat's records over neighbouring tiles give
    tile[c // 3:c // 3 + 200] = 7
    if depths == "mixed":
        depth = rng.choice(MIXED, c)
    else:
        depth = rng.random(c).astype(np.float32)
        depth[::97] = depth[0]                      # exact ties
    fields = rng.normal(0, 1, (kr.NUM_FIELDS, c)).astype(np.float32)
    return tile, depth, fields


def _packed_np(tile, depth):
    q = np.uint32(1 << kr.PACKED_DEPTH_BITS)
    qd = np.minimum((np.clip(depth, 0.0, 1.0) * float(q)).astype(np.uint32), q - 1)
    return tile.astype(np.uint32) * q + qd


def _jax_sort(key, tiles, tile, depth, fields):
    """The JAX package's record sort of the case and its vjp function:
    ((sorted fields (9, C), bounds, source index), vjp)."""
    rows = tuple(jnp.asarray(f) for f in fields)
    if key == "pair":
        def sort(rows):
            (sk, _), si, sf = jax_records.sort_multi_with_payload(
                (jnp.asarray(tile), jnp.asarray(depth)), rows)
            return sf, (sk, si)
        bnd = jnp.arange(tiles + 1, dtype=jnp.int32)
    else:
        def sort(rows):
            sk, si, sf = jax_records.sort_with_payload(
                jnp.asarray(_packed_np(tile, depth)), rows)
            return sf, (sk, si)
        bnd = (jnp.arange(tiles + 1, dtype=jnp.uint32)
               * jnp.uint32(1 << kr.PACKED_DEPTH_BITS))
    sf, vjp, (sk, si) = jax.vjp(sort, rows, has_aux=True)
    bounds = jnp.searchsorted(sk, bnd, side="left").astype(jnp.int32)
    return (np.stack([np.asarray(r) for r in sf]), np.asarray(bounds),
            np.asarray(si)), vjp


@pytest.mark.parametrize("name", list(CASES))
def test_record_sort_plain_versions_and_jax_agree_bit_for_bit(name):
    key, tiles, c, depths = CASES[name]
    tile, depth, fields = _records(key, tiles, c, depths)
    f = torch.from_numpy(fields)
    words = rs.words_of(torch.from_numpy(tile), torch.from_numpy(depth), key)
    # the words are the two halves of the int64 key the port sorted before
    want_key = (kr.pair_key if key == "pair" else kr.packed_key)(
        torch.from_numpy(tile), torch.from_numpy(depth))
    assert torch.equal(rs.key64(words, key), want_key)
    assert torch.equal(rs.tile_of(words, key), torch.from_numpy(tile))

    sf, bounds, si = rs.record_sort_plain(f, words, tiles, key)
    model = rs.record_sort_passes_plain(f, words, tiles, key)
    assert torch.equal(model[0], sf)
    assert torch.equal(model[1], bounds)          # the tile histogram's bounds
    assert torch.equal(model[2].to(torch.int64), si)
    # against JAX on the draws without -0.0 (the module docstring says why)
    depth = np.where(depth == 0, np.float32(0.0), depth)
    j_words = rs.words_of(torch.from_numpy(tile), torch.from_numpy(depth), key)
    sf, bounds, si = rs.record_sort_plain(f, j_words, tiles, key)
    (j_sf, j_bounds, j_si), _ = _jax_sort(key, tiles, tile, depth, fields)
    np.testing.assert_array_equal(sf.numpy(), j_sf)
    np.testing.assert_array_equal(bounds.numpy(), j_bounds)
    np.testing.assert_array_equal(si.numpy(), j_si)
    words = j_words
    # the invalid tile sorts last; bounds[-1] counts the records before it
    assert int(bounds[-1]) == int((tile < tiles).sum())
    # the autograd stage on the CPU runs either plain version
    for passes_model in (False, True):
        got = rs.record_sort(f, words, tiles, key, passes_model=passes_model)
        assert torch.equal(got[0], sf) and torch.equal(got[1], bounds)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["pair-512-ragged", "packed-512-ragged",
                                  "pair-2040-ragged"])
def test_unsort_forms_match_index_copy_and_jax_vjp(name, mode, monkeypatch):
    monkeypatch.setattr(kr, "BWD_COT_PACK", mode)
    monkeypatch.setattr(jax_records, "BWD_COT_PACK", mode)
    key, tiles, c, depths = CASES[name]
    tile, depth, fields = _records(key, tiles, c, depths, seed=1)
    depth = np.where(depth == 0, np.float32(0.0), depth)   # as JAX orders zeros
    f = torch.from_numpy(fields).requires_grad_(True)
    words = rs.words_of(torch.from_numpy(tile), torch.from_numpy(depth), key)
    g = np.random.default_rng(2).normal(0, 1e-3, (kr.NUM_FIELDS, c)).astype(np.float32)
    gt = torch.from_numpy(g)
    paired = 8 if mode == "bf16" else 0
    _, _, si = rs.record_sort_plain(f.detach(), words, tiles, key)
    want = rs.unsort_plain(gt, si, paired)
    assert torch.equal(rs.unsort_gather_plain(gt, rs.inverse_plain(si), paired), want)
    if mode == "bf16":
        assert not torch.equal(want, rs.unsort_plain(gt, si, 0))
        assert torch.equal(want[8], rs.unsort_plain(gt, si, 0)[8])
    # the stage's own backward, both plain versions
    for passes_model in (False, True):
        sf, _ = rs.record_sort(f, words, tiles, key, passes_model=passes_model)
        (got,) = torch.autograd.grad(sf, f, gt)
        assert torch.equal(got, want)
    _, vjp = _jax_sort(key, tiles, tile, depth, fields)
    (j_g,) = vjp(tuple(jnp.asarray(r) for r in g))
    np.testing.assert_array_equal(want.numpy(), np.stack([np.asarray(r) for r in j_g]))


def test_pair_words_order_negative_zero_below_positive_zero():
    depth = torch.tensor([0.0, -0.0, -1.0, 1.0, -0.0, 0.0], dtype=torch.float32)
    tile = torch.zeros(6, dtype=torch.int32)
    fields = torch.arange(6, dtype=torch.float32).expand(kr.NUM_FIELDS, 6).contiguous()
    words = rs.words_of(tile, depth, "pair")
    for sort in (rs.record_sort_plain, rs.record_sort_passes_plain):
        sf, bounds, _ = sort(fields, words, 4, "pair")
        np.testing.assert_array_equal(sf[0].numpy(), [2, 1, 4, 0, 5, 3])
        np.testing.assert_array_equal(bounds.numpy(), [0, 6, 6, 6, 6])


def test_negative_zero_is_the_one_difference_from_lax_sort():
    depth = np.array([0.0, -0.0, 0.5, -0.0, 0.0], np.float32)
    tile = np.zeros(5, np.int32)
    fields = np.tile(np.arange(5, dtype=np.float32), (kr.NUM_FIELDS, 1))
    (j_sf, _, _), _ = _jax_sort("pair", 4, tile, depth, fields)
    np.testing.assert_array_equal(j_sf[0], [0, 1, 3, 4, 2])      # -0.0 == +0.0
    words = rs.words_of(torch.from_numpy(tile), torch.from_numpy(depth), "pair")
    sf, _, _ = rs.record_sort_plain(torch.from_numpy(fields), words, 4, "pair")
    np.testing.assert_array_equal(sf[0].numpy(), [1, 3, 0, 4, 2])  # -0.0 first
    # the packed key quantises both zeros to 0: there the two agree
    (j_sf, _, _), _ = _jax_sort("packed", 4, tile, depth, fields)
    words = rs.words_of(torch.from_numpy(tile), torch.from_numpy(depth), "packed")
    sf, _, _ = rs.record_sort_plain(torch.from_numpy(fields), words, 4, "packed")
    np.testing.assert_array_equal(sf.numpy(), j_sf)


def test_record_sort_probe_refuses_without_a_card():
    import importlib.util
    from pathlib import Path

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_record_sort_probe.py"
    spec = importlib.util.spec_from_file_location("torch_record_sort_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main([])


def test_expansion_writes_the_sort_words():
    # the expansion's fourth output is sort_word of its tile and depth
    # outputs, and the tail past total is the invalid tile at depth 0
    rng = np.random.default_rng(3)
    n = 40
    fields = torch.from_numpy(rng.normal(0, 1, (kr.NUM_FIELDS, n)).astype(np.float32))
    fields[0:2] = torch.from_numpy(rng.uniform(0, 64, (2, n)).astype(np.float32))
    fields[2], fields[4], fields[3] = 0.05, 0.05, 0.0
    fields[5] = 0.9
    tile_min = torch.from_numpy(rng.integers(0, 3, (n, 2)).astype(np.int32))
    tile_ext = torch.from_numpy(rng.integers(1, 3, (n, 2)).astype(np.int32))
    depth = torch.from_numpy(rng.choice(MIXED, n))
    counts = (tile_ext[:, 0] * tile_ext[:, 1]).to(torch.int32)
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    kw = dict(capacity=4096, gx=4, num_tiles=16, pw=16, ph=16, alpha_min=1 / 255)
    base = kr.expand(fields, tile_min, tile_ext, depth, cum, **kw)
    for key in rs.KEYS:
        out = kr.expand(fields, tile_min, tile_ext, depth, cum, **kw, key=key)
        assert len(out) == 4
        for a, b in zip(out[:3], base):
            assert torch.equal(a, b)
        assert torch.equal(out[3], kr.sort_word(out[1], out[2], key))
        assert torch.equal(out[3], kr.expand_plain(fields, tile_min, tile_ext, depth,
                                                   cum, **kw, key=key)[3])
        tail = out[3][int(cum[-1]):]
        assert torch.equal(tail, kr.sort_word(torch.full_like(tail, 16),
                                              torch.zeros(tail.shape[0]), key))


def test_record_sort_checks_raise_what_they_say():
    f = torch.zeros((kr.NUM_FIELDS, 8))
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="key must be"):
        rs.record_sort_fwd(f, (w,), 4, "reference")
    with pytest.raises(ValueError, match="2 words"):
        rs.record_sort_fwd(f, (w,), 4, "pair")
    with pytest.raises(ValueError, match="512 tiles"):
        rs.record_sort_fwd(f, (w,), 2040, "packed")
    with pytest.raises(TypeError, match="int32"):
        rs.record_sort_fwd(f, (w.to(torch.int64),), 4, "packed")
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        rs.record_sort_fwd(f.to("meta"), (w.to("meta"),), 4, "packed")
    before = rs.record_sort.launches, rs.record_unsort.launches
    sf, bounds = rs.record_sort(f.requires_grad_(True), (w,), 4, "packed")
    torch.autograd.grad(sf.sum(), f)
    assert (rs.record_sort.launches, rs.record_unsort.launches) == before
    assert bounds.tolist() == [0, 8, 8, 8, 8]


N, W, H = 20, 64, 64
FRAME = dict(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)


def _frame_args():
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(N, seed=5, extent=2.0).items()
             if k != "sh_rest"}
    a = jax_camera_args(JaxCamera(0.0, 0.0, -5.0, width=W, height=H))
    cam = (a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)
    return scene, a, cam


@functools.lru_cache(maxsize=None)
def _jax_sorted(depth_key):
    """The JAX fast path's sorted fields and bounds (``stop_after="sort2"``)
    and its jax arguments."""
    scene, a, cam = _frame_args()
    jargs = ({k: jnp.asarray(v) for k, v in scene.items()}, jnp.asarray(a["view"]),
             jnp.asarray(a["vp"])) + cam + (JaxConfig(**FRAME, depth_key=depth_key),)
    _, aux = jax_fastpath.render_fast(*jargs, stop_after="sort2")
    return (np.stack([np.asarray(r) for r in aux["fields"]]), np.asarray(aux["bounds"]),
            jargs)


def _port_args(**opts):
    scene, a, cam = _frame_args()
    return (params_from_numpy(scene, "cpu"), torch.from_numpy(a["view"]),
            torch.from_numpy(a["vp"])) + cam + (RenderConfig(**FRAME, **opts),)


@pytest.mark.parametrize("opts", [dict(depth_key="pair"), dict(depth_key="packed"),
                                  dict(depth_key="packed", record_sort="radix")],
                         ids=["pair", "packed", "packed-radix"])
def test_render_fast_record_sort_matches_jax_fast_path(opts):
    # the sorted records and bounds bit for bit; the pair frame (the
    # default) against JAX's image and stats, the packed routes' frames
    # against each other
    j_sf, j_bounds, jargs = _jax_sorted(opts["depth_key"])
    targs = _port_args(**opts)
    _, aux = fastpath.render_fast(*targs, stop_after="sort2")
    np.testing.assert_array_equal(aux["fields"].numpy(), j_sf)
    np.testing.assert_array_equal(aux["bounds"].numpy(), j_bounds)
    img_t, st_t = fastpath.render_fast(*targs)
    assert st_t["binned_records"].item() == int(j_bounds[-1]) > 0
    if opts["depth_key"] == "pair":
        img_j, st_j = jax_fastpath.render_fast(*jargs)
        np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
        assert {k: v.item() for k, v in st_t.items()} == {
            k: np.asarray(v).item() for k, v in st_j.items()}
    else:
        img_l, st_l = fastpath.render_fast(*_port_args(depth_key="packed"))
        assert torch.equal(img_t, img_l)
        assert {k: v.item() for k, v in st_t.items()} == {k: v.item() for k, v in st_l.items()}
