"""The port's numpy golden pipeline (``golden.py``) against the JAX
package's, and the port's oracle against the port's golden.

- On the same packed covariances the two goldens are one numpy program:
  equal with ``np.array_equal``, image and every debug array. From scales
  and quaternions the port builds the covariances with its own torch
  ``build_covariance`` on the CPU: within 1e-6.
- The port's oracle (``render_arrays(use_pallas=False)``) against the
  port's golden within 4e-3 (the ARCHITECTURE.md golden contract), and its
  record statistics equal to the golden's in the reference-rect mode, as
  ``tests/test_render_golden.py`` holds the JAX package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu import golden as jax_golden
from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops.transforms import build_covariance as jax_cov
from openglgaussiansplattingrenderer_tpu.render import camera_args

from openglgaussiansplattingrenderer_tpu_torch import golden
from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = dict(use_pallas=False, max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)
SINGLE = dict(use_pallas=False, max_per_tile=256, chunk=64, dup_capacity_factor=256.0)
SCENES = {
    "single@256x256": (jax_ply.single_splat_scene, -3.0, 256, 256, SINGLE),
    "red@256x256": (jax_ply.red_splat_scene, -3.0, 256, 256, SINGLE),
    "300@128x128": (lambda: jax_ply.make_synthetic_scene(300, seed=7, extent=2.0),
                    -6.0, 128, 128, BASE),
}


def _case(name):
    make, z, w, h, opts = SCENES[name]
    scene = make()
    a = camera_args(JaxCamera(0.0, 0.0, z, width=w, height=h))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], w, h)
    return scene, args, opts


@pytest.mark.parametrize("name", list(SCENES))
def test_golden_matches_jax_golden(name):
    scene, args, opts = _case(name)
    cov6 = np.asarray(jax_cov(jnp.asarray(scene["scales"]), jnp.asarray(scene["quats"])))
    gp = {"means": scene["means"], "cov6": cov6, "opacities": scene["opacities"],
          "colors": scene["colors"]}
    img, dbg = golden.golden_render(gp, *args, RenderConfig(**opts))
    img_j, dbg_j = jax_golden.golden_render(gp, *args, JaxConfig(**opts))
    assert img_j[..., 3].max() > 0.5
    assert np.array_equal(img, img_j)
    assert set(dbg) == set(dbg_j)
    for k in dbg_j:
        assert np.array_equal(dbg[k], dbg_j[k]), k
    # from scales and quaternions: the port's covariance build, on the CPU
    sq = {k: scene[k] for k in ("means", "scales", "quats", "opacities", "colors")}
    img_sq, _ = golden.golden_render(sq, *args, RenderConfig(**opts))
    np.testing.assert_allclose(img_sq, img_j, atol=1e-6)


@pytest.mark.parametrize("name", list(SCENES))
def test_oracle_matches_golden(name):
    scene, args, opts = _case(name)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    img, stats = render_arrays(params_from_numpy(scene, "cpu"), *args,
                               RenderConfig(**opts))
    gold, _ = golden.golden_render(scene, *args, RenderConfig(**opts))
    assert int(stats["overflow"]) == 0 and int(stats["dropped_by_cap"]) == 0
    np.testing.assert_allclose(img.numpy(), gold, atol=4e-3)


def test_oracle_stats_match_golden():
    # the reference rectangle (tight_rect=False) keeps the golden's counts
    cfg = dataclasses.replace(RenderConfig(**BASE), tight_rect=False)
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(
        500, seed=13, extent=3.0).items() if k != "sh_rest"}
    a = camera_args(JaxCamera(0.0, 0.0, -8.0, width=128, height=128))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], 128, 128)
    img, stats = render_arrays(params_from_numpy(scene, "cpu"), *args, cfg)
    gold, dbg = golden.golden_render(scene, *args, cfg)
    np.testing.assert_allclose(img.numpy(), gold, atol=4e-3)
    assert int(stats["num_records"]) == len(dbg["sorted_sids"])
    assert int(stats["num_visible"]) == int(np.sum(dbg["valid"]))
    assert int(stats["num_culled"]) == int(np.sum(dbg["culled"]))
    assert int(stats["max_bin"]) == int(np.max(np.diff(dbg["bounds"])))
