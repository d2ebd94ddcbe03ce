"""``render_fast(stop_after=...)`` of the port against the JAX package's
(Pallas in interpret mode) at 20 splats and 64x64, for every stage name,
with ``hoist_depth_sort`` True and False:

- "prep": mean2d, conic, depth and colours within 1e-5;
- "sort1": the splat table's 9 field rows within 1e-5 (rows 0-8 of JAX's
  13-row table), the tile rect and the counts (rows 9-12) exact;
- "cumsum": exact;
- "expand": the 9 field rows, the tile row and (without the hoisted sort,
  where JAX carries it) the depth row exact over the valid records;
- "sort2": sorted fields within 1e-6, bounds exact.

With ``stop_after=None`` the frame equals the frame composed from the
stages' own functions (splat table, prefix sum, expansion, record sort,
compositor) bit for bit; an unknown name raises ``ValueError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops import fastpath as jax_fastpath
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import assemble_image
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, W, H = 20, 64, 64
CFG = dict(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)
HOIST = [False, True]


def _frame(hoist):
    scene = jax_ply.make_synthetic_scene(N, seed=5, extent=2.0)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    a = jax_camera_args(JaxCamera(0.0, 0.0, -5.0, width=W, height=H))
    cam = (a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"], W, H)
    jargs = ({k: jnp.asarray(v) for k, v in scene.items()}, jnp.asarray(a["view"]),
             jnp.asarray(a["vp"])) + cam + (JaxConfig(hoist_depth_sort=hoist, **CFG),)
    targs = (params_from_numpy(scene, "cpu"), torch.from_numpy(a["view"]),
             torch.from_numpy(a["vp"])) + cam + (
                 RenderConfig(hoist_depth_sort=hoist, **CFG),)
    return jargs, targs


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("hoist", HOIST)
def test_prep_matches_jax(hoist):
    jargs, targs = _frame(hoist)
    jout, jaux = jax_fastpath.render_fast(*jargs, stop_after="prep")
    out, aux = fastpath.render_fast(*targs, stop_after="prep")
    assert set(aux) == set(jaux) == {"conic", "colors", "depth"}
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5, rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hoist", HOIST)
def test_sort1_matches_jax(hoist):
    jargs, targs = _frame(hoist)
    jout, jaux = jax_fastpath.render_fast(*jargs, stop_after="sort1")
    out, aux = fastpath.render_fast(*targs, stop_after="sort1")
    jrows = np.stack([_np(r) for r in jaux["fields"]])
    assert jrows.shape == (13, N)
    np.testing.assert_allclose(_np(aux["fields"]), jrows[:9], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(out), _np(aux["fields"][0]))
    np.testing.assert_array_equal(_np(aux["tile_min"]), jrows[9:11].T)
    np.testing.assert_array_equal(_np(aux["tile_ext"])[:, 0], jrows[11])
    np.testing.assert_array_equal(_np(aux["counts"]), jrows[12])


@pytest.mark.parametrize("hoist", HOIST)
def test_cumsum_matches_jax(hoist):
    jargs, targs = _frame(hoist)
    jout, _ = jax_fastpath.render_fast(*jargs, stop_after="cumsum")
    out, aux = fastpath.render_fast(*targs, stop_after="cumsum")
    assert out.dtype == torch.int32 and int(out[-1]) > N
    np.testing.assert_array_equal(_np(out), _np(jout))
    assert aux["fields"].shape == (9, N)


@pytest.mark.parametrize("hoist", HOIST)
def test_expand_matches_jax(hoist):
    jargs, targs = _frame(hoist)
    rec_sm, jaux = jax_fastpath.render_fast(*jargs, stop_after="expand")
    rec_sm = _np(rec_sm)
    out, aux = fastpath.render_fast(*targs, stop_after="expand")
    cum, _ = fastpath.render_fast(*targs, stop_after="cumsum")
    total = int(cum[-1])
    assert jaux == {} and out.shape == (9, rec_sm.shape[1])
    assert 0 < total < out.shape[1]
    np.testing.assert_array_equal(_np(out)[:, :total], rec_sm[0:9, :total])
    np.testing.assert_array_equal(_np(aux["tile"])[:total],
                                  rec_sm[9, :total].astype(np.int32))
    if not hoist:
        np.testing.assert_array_equal(_np(aux["depth"])[:total], rec_sm[10, :total])
    assert (_np(aux["tile"])[total:] == targs[-1].num_tiles).all()


@pytest.mark.parametrize("hoist", HOIST)
def test_sort2_matches_jax(hoist):
    jargs, targs = _frame(hoist)
    jout, jaux = jax_fastpath.render_fast(*jargs, stop_after="sort2")
    out, aux = fastpath.render_fast(*targs, stop_after="sort2")
    jfields = np.stack([_np(f) for f in jaux["fields"]])
    bounds = _np(aux["bounds"])
    np.testing.assert_array_equal(bounds, _np(jaux["bounds"]))
    assert bounds[-1] > 0
    np.testing.assert_allclose(_np(aux["fields"]), jfields, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(out), _np(aux["fields"][0]))


@pytest.mark.parametrize("hoist", HOIST)
def test_full_frame_unchanged(hoist):
    _, targs = _frame(hoist)
    params, view, vp = targs[:3]
    cfg = targs[-1]
    img, stats = fastpath.render_fast(*targs, stop_after=None)
    # the frame composed from the stages' own functions, as before the cut
    stage = fastpath.expand_depth_records(*targs, key=fastpath.record_key(cfg))
    sf, bounds = fastpath.sort_records(*stage, W, H, cfg)
    tiled, _, _ = fastpath.composite_sorted(
        sf, bounds, num_tiles=cfg.num_tiles,
        tile_ids=torch.arange(cfg.num_tiles, dtype=torch.int32), width=W, height=H,
        cfg=cfg)
    want = assemble_image(tiled[:, :, 0:3], tiled[:, :, 3], W, H, cfg)
    assert torch.equal(img, want)
    assert int(stats["binned_records"]) == int(bounds[-1]) > 0


@pytest.mark.parametrize("name", ["sort", "composite", "", "PREP"])
def test_unknown_stage_raises(name):
    _, targs = _frame(False)
    with pytest.raises(ValueError, match="stop_after"):
        fastpath.render_fast(*targs, stop_after=name)
    with pytest.raises(ValueError, match="stop_after"):
        fastpath.expand_depth_records(*targs, stop_after=name)
