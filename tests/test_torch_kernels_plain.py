"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode.

- prefix sum: exact;
- expansion: the 9 fields, the tile ids and the depths exactly equal over
  the valid records [0, total), and every record past total invalid;
- compositor, fed the JAX pipeline's own sorted records and bounds: rgb in
  image units (divided by the colour scale, as ``assemble_image`` does)
  and transmittance within 2e-5. The two sum the chunk's colour products
  in different orders; the transmittance prefix is the same scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops import fastpath as jax_fastpath
from openglgaussiansplattingrenderer_tpu.ops.pallas import scan as jax_scan
from openglgaussiansplattingrenderer_tpu.render import camera_args

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

CFG = dict(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)
SCENES = [(3, 150, 128, 128), (9, 400, 128, 64)]


@pytest.mark.parametrize("n", [1, 100, 5000, 70000])
def test_cumsum_matches_pallas(n):
    x = np.random.default_rng(n).integers(0, 100, n).astype(np.int32)
    want = np.asarray(jax_scan.cumsum(jnp.asarray(x)))
    got = ks.cumsum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_cumsum_on_views_with_an_offset(offset):
    # a contiguous view that starts off the 16-byte grid is a valid input
    x = np.random.default_rng(offset).integers(-50, 100, 9000).astype(np.int32)
    view = torch.from_numpy(x)[offset:]
    assert view.storage_offset() == offset and view.is_contiguous()
    got = ks.cumsum(view)
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x[offset:], dtype=np.int32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_scan.cumsum(jnp.asarray(x[offset:]))))


def test_cumsum_wraps_as_int32():
    x = np.full(10, 2 ** 30, np.int32)
    want = np.cumsum(x.astype(np.int64)).astype(np.uint64).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(ks.cumsum(torch.from_numpy(x)).numpy(), want)


def test_cumsum_checks_raise_what_they_say():
    with pytest.raises(TypeError, match="int32"):
        ks.cumsum(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        ks.cumsum(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ks.cumsum(torch.zeros(16, dtype=torch.int32)[::2])
    with pytest.raises(ValueError, match="exceed int32 indexing"):
        ks.cumsum(torch.empty(2 ** 31, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CPU or all on one CUDA device"):
        ks.cumsum(torch.empty(8, dtype=torch.int32, device="meta"))
    # int32 words one byte off their grid: no kernel access is that narrow
    raw = np.zeros(64, np.uint8)
    odd = raw[(-raw.ctypes.data) % 4 + 1:][:16].view(np.int32)
    assert odd.ctypes.data % 4 == 1
    with pytest.raises(ValueError, match="4-byte aligned"):
        ks.cumsum(torch.from_numpy(odd))
    assert ks.cumsum(torch.zeros(0, dtype=torch.int32)).shape == (0,)


def _frame(seed, n, w, h):
    scene = jax_ply.make_synthetic_scene(n, seed=seed, extent=2.0)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    a = camera_args(Camera(0.0, 0.0, -6.0, width=w, height=h))
    jargs = ({k: jnp.asarray(v) for k, v in scene.items()},
             jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
             a["focal_y"], a["tan_fovx"], a["tan_fovy"], w, h)
    targs = (params_from_numpy(scene, "cpu"), torch.from_numpy(a["view"]),
             torch.from_numpy(a["vp"]), a["focal_x"], a["focal_y"],
             a["tan_fovx"], a["tan_fovy"], w, h)
    return jargs, targs


@pytest.mark.parametrize("seed,n,w,h", SCENES)
def test_expand_matches_pallas(seed, n, w, h):
    jargs, targs = _frame(seed, n, w, h)
    _, rec_sm, _ = jax_fastpath.expand_depth_records(
        *jargs, JaxConfig(**CFG), stop_after="expand")
    rec_sm = np.asarray(rec_sm)
    cfg = RenderConfig(**CFG)
    table, prep = fastpath.splat_table(*targs, cfg)
    cum = ks.cumsum(prep["counts"])
    kw = fastpath.expand_kwargs(n, w, h, cfg)
    fields, tile, depth = kr.expand(*table, cum, **kw)
    cap = kw["capacity"]
    assert fields.shape == (9, cap) and rec_sm.shape[1] == cap
    total = min(int(cum[-1]), cap)
    assert 0 < total < cap
    np.testing.assert_array_equal(fields[:, :total].numpy(), rec_sm[0:9, :total])
    np.testing.assert_array_equal(tile[:total].numpy(),
                                  rec_sm[9, :total].astype(np.int32))
    np.testing.assert_array_equal(depth[:total].numpy(), rec_sm[10, :total])
    # the cull marked some records invalid, and everything past total is
    assert (tile[:total] == cfg.num_tiles).any()
    assert (tile[total:] == cfg.num_tiles).all()
    assert (rec_sm[9, total:] == cfg.num_tiles).all()
    assert not fields[:, total:].any() and not depth[total:].any()
    # the record sort's key word the expansion writes beside them, from the
    # JAX slab's tile and depth rows: the pair key's low word (the depth's
    # bits, order-kept) and the packed key
    j_tile, j_depth = rec_sm[9, :total].astype(np.uint32), rec_sm[10, :total]
    bits = j_depth.view(np.uint32)
    q = np.uint32(1 << kr.PACKED_DEPTH_BITS)
    want = {"pair": np.where(bits >> 31, ~bits, bits | np.uint32(1 << 31)),
            "packed": j_tile * q + np.minimum(
                (np.clip(j_depth, 0.0, 1.0) * float(q)).astype(np.uint32), q - 1)}
    for key, w in want.items():
        out = kr.expand(*table, cum, **kw, key=key)
        assert len(out) == 4 and torch.equal(out[0], fields) and torch.equal(out[1], tile)
        np.testing.assert_array_equal(out[3][:total].numpy().view(np.uint32), w)


@pytest.mark.parametrize("seed,n,w,h", SCENES)
def test_composite_matches_pallas(seed, n, w, h):
    jargs, _ = _frame(seed, n, w, h)
    jcfg = JaxConfig(**CFG)
    _, out = jax_fastpath.render_fast(*jargs, jcfg, stop_after="sort2")
    sf2, bounds = out["fields"], out["bounds"]
    t = jcfg.num_tiles
    want, _, _ = jax_fastpath.composite_sorted(
        sf2, bounds, capacity=sf2[0].shape[0], num_tiles=t,
        tile_ids=jnp.arange(t, dtype=jnp.int32), width=w, height=h, cfg=jcfg)
    want = np.asarray(want)

    rec = torch.from_numpy(np.stack([np.array(f) for f in sf2]))
    tb = torch.from_numpy(np.array(bounds))
    cfg = RenderConfig(**CFG)
    got, _, counts = fastpath.composite_sorted(
        rec, tb, num_tiles=t, tile_ids=torch.arange(t, dtype=torch.int32),
        width=w, height=h, cfg=cfg)
    got = got.numpy()
    assert got.shape == want.shape
    assert int(tb[-1]) > 0 and (want[:, :, 3] < 0.5).any()
    np.testing.assert_allclose(got[:, :, :3] / cfg.color_scale,
                               want[:, :, :3] / cfg.color_scale, atol=2e-5)
    np.testing.assert_allclose(got[:, :, 3], want[:, :, 3], atol=2e-5)
    np.testing.assert_array_equal(counts.numpy(), np.diff(np.asarray(bounds)))


def test_tile_origins_match_pallas():
    from openglgaussiansplattingrenderer_tpu.ops.pallas import composite as jc

    ids = np.arange(40, dtype=np.int32)
    want = jc.tile_origins(jnp.asarray(ids), 8, 4, 6)
    got = kc.tile_origins(torch.from_numpy(ids), 8, 4, 6)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pair_key_orders_like_a_lexicographic_sort():
    # ties, negative depths and both zeros: the int64 key must sort like
    # the stable (tile, depth) sort, i.e. numpy's lexsort
    rng = np.random.default_rng(2)
    tile = rng.integers(0, 5, 500).astype(np.int32)
    depth = rng.choice(np.array([-2.5, -1e-3, -0.0, 0.0, 1e-30, 0.25, 0.25, 1.0,
                                 3e8], np.float32), 500)
    key = kr.pair_key(torch.from_numpy(tile), torch.from_numpy(depth))
    fields = torch.arange(500, dtype=torch.float32)[None, :]
    _, idx, sf = kr.sort_with_payload(key, fields)
    # numpy orders -0.0 == 0.0; the key orders -0.0 first, as a total order
    # does (lexsort: last key primary, stable)
    want = np.lexsort((~(np.signbit(depth) & (depth == 0)), depth, tile))
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(sf[0].numpy(), want.astype(np.float32))


def test_packed_key_matches_fastpath_formula():
    rng = np.random.default_rng(4)
    tile = rng.integers(0, 512, 1000).astype(np.int32)
    depth = rng.uniform(-0.1, 1.1, 1000).astype(np.float32)
    q = np.uint32(1 << 22)
    qd = np.minimum((np.clip(depth, 0.0, 1.0) * (1 << 22)).astype(np.uint32), q - 1)
    want = tile.astype(np.uint32) * q + qd
    got = kr.packed_key(torch.from_numpy(tile), torch.from_numpy(depth))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num_tiles", [1, 2, 511, 512, 2040])
def test_packed_key_bits_hold_every_key(num_tiles):
    # the radix sort's key widths, as the JAX fast path takes them: the
    # invalid tile's largest key fills exactly packed_key_bits
    tile = torch.tensor([0, num_tiles], dtype=torch.int32)
    key = kr.packed_key(tile, torch.tensor([0.0, 1.0]))
    bits = kr.packed_key_bits(num_tiles)
    assert bits == 22 + max(1, num_tiles.bit_length())
    assert int(key.max()).bit_length() == bits
    assert kr.tile_key_bits(num_tiles) == bits - kr.PACKED_DEPTH_BITS
