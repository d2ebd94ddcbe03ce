"""The record sort stage by splat (``ops/kernels/record_sort.py``) on the CPU.

A record's nine fields are a copy of its splat's, so the frame's expansion
writes each record's splat id in their place (``records.expand_ids``) and
the stage gathers the sorted records' fields by splat
(``record_sort_splats``) from the splat table's pair layout: fields 0-7 as
four (N + 1, 2) arrays, field 8 as an (N + 1,) array, row N zero for the
records past the total, which the splat table stores beside its fields
(``splat_table(..., pairs=True)``). On the CPU each piece runs its plain
version. Every piece is a permutation or a copy, so every case holds bit
for bit, with no tolerance:

- the splat ids against ``searchsorted(cum_incl, r, right=True)``, N past
  the total, and the expansion's other outputs against its field mode;
- the pair layout gathered by the ids against the field mode's (9, C)
  fields, and ``splat_fields``' gradient against ``Expand``'s;
- the stage's plain versions against ``record_sort_plain`` of the field
  mode's records and against the JAX package's payload sort, both keys;
- the un-sort against ``unsort_plain`` in the f32 and bf16 cotangent modes
  and against the JAX sort's VJP, and the stage's gradient against the
  field route's (``Expand`` then the sort of its fields, ``FieldSort``).

The scenes are frames of 20 splats at 64x64 (16 tiles) expanded at a
chosen capacity: as they come (records the cull drops among them), with
splats far off the screen (no records), with one splat over every tile,
and past the capacity. Last, ``render_fast`` with the default and the
packed key: the image and the gradients against the JAX fast path, and
bit for bit against the route through the field mode and the sort of its
fields.
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
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt
from _torch_threads import one_torch_thread  # noqa: F401, E402
from test_torch_record_sort import FieldSort, _jax_sort, field_route

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, W, H = 20, 64, 64
FRAME = dict(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)
CASES = ["frame", "empty_splats", "large_splat", "overflow", "capacity_not_x4"]
KEYS = ["pair", "packed"]


def _scene(name):
    scene = {k: v.copy() for k, v in
             jax_ply.make_synthetic_scene(N, seed=5, extent=2.0).items() if k != "sh_rest"}
    if name == "empty_splats":
        scene["means"][3:9, 0] = 500.0          # far off the screen: no records
    if name == "large_splat":
        scene["means"][0] = 0.0
        scene["scales"][0] = 1.5                 # over every tile
    return scene


def _cam():
    a = jax_camera_args(JaxCamera(0.0, 0.0, -5.0, width=W, height=H))
    return a, (a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)


def _port_args(scene, **opts):
    a, cam = _cam()
    return (params_from_numpy(scene, "cpu"), torch.from_numpy(a["view"]),
            torch.from_numpy(a["vp"])) + cam + (RenderConfig(**FRAME, **opts),)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(splat table, cum_incl, expand kwargs) of a case: the frame's own
    table, expanded at a capacity of the case's."""
    args = _port_args(_scene(name))
    cfg = args[-1]
    table, prep = fastpath.splat_table(*args)
    table = tuple(t.detach() for t in table)
    cum = ks.cumsum(prep["counts"])
    total = int(cum[-1])
    kw = fastpath.expand_kwargs(N, W, H, cfg)
    kw["capacity"] = {"overflow": total - 37,
                      "capacity_not_x4": total + 7 + (total % 4 == 1)}.get(name, total + 12)
    counts = prep["counts"]
    if name == "empty_splats":
        assert int((counts == 0).sum()) >= 6
    if name == "large_splat":
        assert int(counts.max()) == cfg.num_tiles
    return table, cum, kw


def _records(name, key):
    """(the field mode's (fields, tile, depth) and the sort word of those,
    the splat-id mode's outputs)."""
    table, cum, kw = _case(name)
    full = kr.expand(*table, cum, **kw)
    return (full + (kr.sort_word(full[1], full[2], key),),
            kr.expand_ids(*table, cum, **kw, key=key))


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("name", CASES)
def test_splat_ids_are_each_records_splat(name, key):
    table, cum, kw = _case(name)
    full, ids = _records(name, key)
    cap = kw["capacity"]
    r = torch.arange(cap, dtype=torch.int32)
    total = min(int(cum[-1]), cap)
    want = torch.where(r < total, torch.searchsorted(cum, r, right=True).to(torch.int32), N)
    assert torch.equal(ids[0], want) and torch.equal(kr.splat_ids_plain(cum, cap), want)
    cum_excl = torch.cat([cum.new_zeros(1), cum[:-1]])
    s = ids[0][:total].to(torch.int64)
    assert bool(((cum_excl[s] <= r[:total]) & (r[:total] < cum[s])).all())
    for a, b in zip(ids[1:], full[1:]):                   # tile, depth, word
        assert torch.equal(a, b)
    t = kw["num_tiles"]
    culled = int((full[1][:total] == t).sum())
    assert bool((full[1][total:] == t).all())
    if name == "frame":
        assert 0 < culled < total                         # the cull drops some


@pytest.mark.parametrize("name", CASES)
def test_layouts_gathered_by_splat_ids_are_the_field_mode(name):
    table, cum, kw = _case(name)
    full, ids = _records(name, "pair")
    fields, c = table[0], kw["capacity"]
    assert torch.equal(rs.fields_of_splats_plain(fields, ids[0]), full[0])
    # the pair layout, element by element, as the splat table stores it
    pairs = kt.splat_pairs_plain(fields)
    m = N + 1
    assert pairs.shape == (kt.PAIR_LAYOUT_ROWS * m,)
    for f in range(8):
        assert torch.equal(pairs[(f // 2) * 2 * m:(f // 2 + 1) * 2 * m][f % 2::2][:N], fields[f])
    assert torch.equal(pairs[8 * m:9 * m - 1], fields[8])
    assert not pairs[2 * m - 2:2 * m].any() and pairs[-1] == 0
    args = _port_args(_scene(name))
    _, prep = fastpath.splat_table(*args, pairs=True)
    assert torch.equal(prep["pairs"], pairs) and not prep["pairs"].requires_grad
    # splat_fields (render_fast(stop_after="expand")): the same fields and,
    # through records.segsum, the expansion's gradient
    f = fields.clone().requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(9, c)).astype(np.float32))
    want = kr.expand(f, *table[1:], cum, **kw)[0]
    g_want = torch.autograd.grad(want, f, g)[0]
    got = rs.splat_fields(f, pairs, ids[0], cum)
    assert torch.equal(got, full[0])
    assert torch.equal(torch.autograd.grad(got, f, g)[0], g_want)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("name", CASES)
def test_stage_by_splat_matches_the_plain_stage_and_jax(name, key):
    table, cum, kw = _case(name)
    full, ids = _records(name, key)
    words = rs.words_of(full[1], full[2], key, full[3])
    want = rs.record_sort_plain(full[0], words, kw["num_tiles"], key)
    for passes_model in (False, True):
        got = rs.record_sort_splats_plain(table[0], ids[0], words, kw["num_tiles"], key,
                                            passes_model)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2].to(torch.int64), want[2])
        sf, bounds = rs.record_sort_splats(table[0], kt.splat_pairs_plain(table[0]), ids[0],
                                           words, kw["num_tiles"], key, cum,
                                           passes_model=passes_model)
        assert torch.equal(sf, want[0]) and torch.equal(bounds, want[1])
    (j_sf, j_bounds, j_si), _ = _jax_sort(key, kw["num_tiles"], full[1].numpy(), full[2].numpy(),
                                         full[0].numpy())
    np.testing.assert_array_equal(want[0].numpy(), j_sf)
    np.testing.assert_array_equal(want[1].numpy(), j_bounds)
    np.testing.assert_array_equal(want[2].numpy(), j_si)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("name,key", [("frame", "pair"), ("overflow", "packed"),
                                      ("large_splat", "pair")])
def test_unsort_and_the_stage_gradient(name, key, mode, monkeypatch):
    monkeypatch.setattr(kr, "BWD_COT_PACK", mode)
    monkeypatch.setattr(jax_records, "BWD_COT_PACK", mode)
    table, cum, kw = _case(name)
    full, ids = _records(name, key)
    words = rs.words_of(full[1], full[2], key, full[3])
    c = kw["capacity"]
    _, _, si = rs.record_sort_plain(full[0], words, kw["num_tiles"], key)
    g = torch.from_numpy(np.random.default_rng(3).normal(0, 1e-3, (9, c)).astype(np.float32))
    paired = 8 if mode == "bf16" else 0
    want = rs.unsort_plain(g, si, paired)
    assert torch.equal(rs.record_unsort(g, si), want)
    assert torch.equal(rs.unsort_gather_plain(g, rs.inverse_plain(si), paired), want)
    _, vjp = _jax_sort(key, kw["num_tiles"], full[1].numpy(), full[2].numpy(), full[0].numpy())
    (j_g,) = vjp(tuple(jnp.asarray(r) for r in g.numpy()))
    np.testing.assert_array_equal(want.numpy(), np.stack([np.asarray(r) for r in j_g]))
    # the stage's gradient: the un-sort, then the segment sum; the field
    # route's: the sort's un-sort, then Expand's segment sum
    f = table[0].clone().requires_grad_(True)
    sf, _ = rs.record_sort_splats(f, kt.splat_pairs_plain(table[0]), ids[0], words,
                                  kw["num_tiles"], key, cum)
    rec_f = kr.expand(f, *table[1:], cum, **kw)[0]
    sf_f, _ = FieldSort.apply(rec_f, words, kw["num_tiles"], key)
    g_field = torch.autograd.grad(sf_f, f, g)[0]
    assert torch.equal(g_field, kr.segsum_plain(want, cum))
    assert torch.equal(torch.autograd.grad(sf, f, g)[0], g_field)


def _loss(img):
    return ((img[..., :3] - 0.2) ** 2).mean() + 0.1 * img[..., 3].mean()


@pytest.mark.parametrize("depth_key", KEYS)
def test_render_fast_by_splat_matches_jax_and_the_field_route(depth_key):
    scene = _scene("frame")
    args = _port_args(scene, depth_key=depth_key)

    def grads(render):
        p = {k: v.clone().requires_grad_(True) for k, v in args[0].items()}
        img = render(p)
        return img.detach(), torch.autograd.grad(_loss(img), list(p.values()))

    img, g = grads(lambda p: fastpath.render_fast(p, *args[1:])[0])
    img_f, g_f = grads(lambda p: field_route(p, *args[1:]))
    assert torch.equal(img, img_f)
    assert all(torch.equal(a, b) for a, b in zip(g, g_f))

    a, cam = _cam()
    jcfg = JaxConfig(**FRAME, depth_key=depth_key)

    def jax_loss(p):
        out, _ = jax_fastpath.render_fast(p, jnp.asarray(a["view"]), jnp.asarray(a["vp"]),
                                          *cam, jcfg)
        return ((out[..., :3] - 0.2) ** 2).mean() + 0.1 * out[..., 3].mean(), out

    (_, img_j), g_j = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in scene.items()})
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=1e-4, rtol=0)
    for k, got in zip(args[0], g):
        want = np.asarray(g_j[k])
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 5e-3, (k, err)


def test_turn_bench_refuses_without_a_card():
    import importlib.util
    from pathlib import Path

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_turn_bench.py"
    spec = importlib.util.spec_from_file_location("torch_turn_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([])
