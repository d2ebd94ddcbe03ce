"""The port's transforms and preprocess against the JAX package (CPU).

Inputs come from numpy seeds and go through both packages. Float outputs
agree to atol 1e-5 / rtol 1e-5 (the same float32 formulas in the same
order; only the elementwise libraries' last-ulp rounding differs); the
integer tile rectangles, counts and masks are exactly equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops import projection as jax_projection
from openglgaussiansplattingrenderer_tpu.ops import transforms as jax_transforms
from openglgaussiansplattingrenderer_tpu.render import camera_args

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import projection, transforms

TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=CPU)


def test_build_covariance_matches_jax():
    rng = np.random.default_rng(5)
    scales = np.exp(rng.uniform(-3, 0.5, (300, 3))).astype(np.float32)
    quats = rng.normal(size=(300, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    want = np.asarray(jax_transforms.build_covariance(jnp.asarray(scales),
                                                      jnp.asarray(quats)))
    got = transforms.build_covariance(_t(scales), _t(quats)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    rot_w = np.asarray(jax_transforms.quat_to_rotmat(jnp.asarray(quats)))
    np.testing.assert_allclose(transforms.quat_to_rotmat(_t(quats)).numpy(),
                               rot_w, **TOL)
    full_w = np.asarray(jax_transforms.unpack_covariance(jnp.asarray(want)))
    np.testing.assert_array_equal(transforms.unpack_covariance(_t(want)).numpy(),
                                  full_w)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(11 + degree)
    n = 200
    dc = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rest = rng.normal(0, 0.3, (n, 45)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jax_transforms.eval_sh(jnp.asarray(dc), jnp.asarray(rest),
                                             jnp.asarray(dirs), degree))
    got = transforms.eval_sh(_t(dc), _t(rest), _t(dirs), degree).numpy()
    # colour-scale units (0..255): rtol carries the tolerance
    np.testing.assert_allclose(got, want, atol=1e-5 * 255, rtol=1e-5)
    view = Camera(1.0, -0.5, -4.0).get_view_matrix()
    np.testing.assert_allclose(
        transforms.camera_center_from_view(_t(view)).numpy(),
        np.asarray(jax_transforms.camera_center_from_view(jnp.asarray(view))),
        **TOL)


FLOAT_KEYS = ("mean2d", "conic", "opacity", "depth", "radius")
EXACT_KEYS = ("counts", "tile_min", "tile_ext", "valid", "culled")


@pytest.mark.parametrize("tight_rect", [True, False])
@pytest.mark.parametrize("antialiased", [False, True])
@pytest.mark.parametrize("int_tile_size", [False, True])
def test_preprocess_matches_jax(tight_rect, antialiased, int_tile_size):
    # 100x70 is not divisible by the 16x16 grid, so int_tile_size matters;
    # extent 3.5 puts some splats outside the frustum
    w, h = 100, 70
    scene = jax_ply.make_synthetic_scene(300, seed=17, extent=3.5)
    cam = Camera(0.3, -0.2, -6.0, width=w, height=h)
    cam.rotate_right(7.0)
    a = camera_args(cam)
    opts = dict(tight_rect=tight_rect, antialiased=antialiased,
                int_tile_size=int_tile_size)
    jcov = jax_transforms.build_covariance(jnp.asarray(scene["scales"]),
                                           jnp.asarray(scene["quats"]))
    want = jax_projection.preprocess(
        jnp.asarray(scene["means"]), jcov, jnp.asarray(scene["opacities"]),
        jnp.asarray(a["view"]), jnp.asarray(a["vp"]), w, h, a["focal_x"],
        a["focal_y"], a["tan_fovx"], a["tan_fovy"],
        dataclasses.replace(JaxConfig(), **opts))
    got = projection.preprocess(
        _t(scene["means"]), _t(np.asarray(jcov)), _t(scene["opacities"]),
        _t(a["view"]), _t(a["vp"]), w, h, a["focal_x"], a["focal_y"],
        a["tan_fovx"], a["tan_fovy"], RenderConfig(**opts))
    assert set(got) == set(want)
    culled = got["culled"].numpy()
    assert 0 < culled.sum() < len(culled)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    for k in EXACT_KEYS:
        assert got[k].dtype == (torch.bool if k in ("valid", "culled")
                                else torch.int32), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
