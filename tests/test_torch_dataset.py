"""The port's posed-image dataset ingestion (``io/dataset.py``) on the CPU,
held to the JAX package's exactly on the same files, mirroring every test
of ``tests/test_dataset.py``.

Tolerances: bundles built or loaded by the two packages from the same
inputs and bytes are equal; the Camera-versus-bundle checks keep
``test_dataset.py``'s own (view 2e-5, vp 2e-4, frames 1e-3, images one u8
step).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.io import dataset as jds
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.io import dataset as ds
from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train import TrainConfig, fit_scene
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = port.RenderConfig(use_pallas=False, chunk=32, max_per_tile=256,
                        dup_capacity_factor=32.0)
W = H = 64


def _bundle_args(b):
    return (b["view"], b["vp"], b["focal_x"], b["focal_y"], b["tan_fovx"],
            b["tan_fovy"])


def _assert_bundles_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _scene(n, seed):
    scene = jax_ply.make_synthetic_scene(n, seed=seed, extent=1.2)
    return {k: v for k, v in scene.items() if k != "sh_rest"}


@pytest.mark.parametrize("intrinsics", ["focal", "angle", "fl_x_only"])
def test_bundle_from_c2w_matches_jax_and_camera(intrinsics):
    cam = port.Camera(1.5, 0.3, -5.0, width=W, height=H)
    cam.set_rotation(-10.0, 25.0, 0.0)
    c2w = np.linalg.inv(cam.get_view_matrix().astype(np.float64))
    kw = {"focal": dict(fl_x=cam.get_focal_x(), fl_y=cam.get_focal_y()),
          "angle": dict(camera_angle_x=0.9),
          "fl_x_only": dict(fl_x=70.0)}[intrinsics]
    b = ds.bundle_from_c2w(c2w, W, H, **kw)
    _assert_bundles_equal(b, jds.bundle_from_c2w(c2w, W, H, **kw))
    if intrinsics == "focal":
        np.testing.assert_allclose(b["view"], cam.get_view_matrix(), atol=2e-5)
        np.testing.assert_allclose(b["vp"], cam.get_vp_matrix(), atol=2e-4)
        assert np.isclose(float(b["focal_x"]), cam.get_focal_x())
        assert np.isclose(float(b["tan_fovx"]), -cam.tan_fovx_correct(), rtol=1e-6)
        assert np.isclose(float(b["tan_fovy"]), -cam.tan_fovy_correct(), rtol=1e-6)
    with pytest.raises(ValueError, match="fl_x or camera_angle_x"):
        ds.bundle_from_c2w(c2w, W, H)


def test_bundle_render_matches_camera_render():
    """A bundle of the Camera's pose renders as the Camera does: only the
    EWA clamp constant differs, invisible for an in-frustum scene."""
    params = convert.params_from_numpy(_scene(60, 3), "cpu")
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    img_cam, _ = render_arrays(params, *_bundle_args(camera_args(cam)), W, H, CFG)
    c2w = np.linalg.inv(cam.get_view_matrix().astype(np.float64))
    b = ds.bundle_from_c2w(c2w, W, H, fl_x=cam.get_focal_x(), fl_y=cam.get_focal_y())
    img_ds, _ = render_arrays(params, *_bundle_args(b), W, H, CFG)
    np.testing.assert_allclose(img_ds.numpy(), img_cam.numpy(), atol=1e-3)


def test_transforms_json_roundtrip_and_fit(tmp_path):
    scene = _scene(40, 7)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    params = convert.params_from_numpy(scene, "cpu")
    bundles, names = [], []
    for i, (x, ry) in enumerate([(0.0, 0.0), (1.0, -15.0)]):
        cam = port.Camera(x, 0.0, -4.0, width=W, height=H)
        cam.set_rotation(0.0, ry, 0.0)
        c2w = np.linalg.inv(cam.get_view_matrix().astype(np.float64))
        b = ds.bundle_from_c2w(c2w, W, H, fl_x=cam.get_focal_x(), fl_y=cam.get_focal_y())
        img, _ = render_arrays(params, *_bundle_args(b), W, H, CFG)
        save_png(str(tmp_path / f"frame_{i}.png"), img[..., :3].numpy())
        bundles.append(b)
        names.append(f"frame_{i}.png")
    ds.save_transforms(str(tmp_path / "transforms.json"), bundles, names)
    jds.save_transforms(str(tmp_path / "jax.json"), bundles, names)
    assert (tmp_path / "transforms.json").read_bytes() == (tmp_path / "jax.json").read_bytes()

    loaded, images = ds.load_transforms(str(tmp_path / "transforms.json"))
    j_loaded, j_images = jds.load_transforms(str(tmp_path / "transforms.json"))
    assert len(loaded) == 2 and all(im is not None for im in images)
    for lb, jb, im, jim, b in zip(loaded, j_loaded, images, j_images, bundles):
        _assert_bundles_equal(lb, jb)
        np.testing.assert_array_equal(im, jim)
        np.testing.assert_allclose(lb["view"], b["view"], atol=1e-5)
        np.testing.assert_allclose(lb["vp"], b["vp"], atol=1e-4)
    img0, _ = render_arrays(params, *_bundle_args(loaded[0]), W, H, CFG)
    assert np.abs(images[0] - img0[..., :3].numpy()).max() <= 1.5 / 255
    # without images: resolutions from the json, image entries None
    _, none = ds.load_transforms(str(tmp_path / "transforms.json"), load_images=False)
    assert none == [None, None]

    # fitting straight from the loaded dataset (bundle dicts as cameras)
    start = dict(scene)
    start["colors"] = np.clip(start["colors"] + np.random.default_rng(0).normal(
        0, 50, start["colors"].shape), 0, 255).astype(np.float32)
    tc = TrainConfig(steps=25, lambda_dssim=0.0)
    _, hist = fit_scene(start, images, loaded, CFG, tc, verbose=False, log_every=12,
                        device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"], hist


def test_nerf_style_transforms_match_jax(tmp_path):
    """A NeRF-synthetic layout (camera_angle_x, file paths without an
    extension, one frame's image missing) loads the same in both."""
    cam = JaxCamera(0.5, 0.2, -3.0, width=32, height=24)
    c2w = np.linalg.inv(cam.get_view_matrix().astype(np.float64))
    rng = np.random.default_rng(1)
    (tmp_path / "train").mkdir()
    save_png(str(tmp_path / "train" / "r_0.png"),
             rng.uniform(0, 1, (24, 32, 4)).astype(np.float32))
    meta = {"camera_angle_x": 0.69, "frames": [
        {"file_path": "./train/r_0", "transform_matrix": c2w.tolist()},
        {"file_path": "./train/r_1", "transform_matrix": c2w.tolist(), "w": 32, "h": 24}]}
    (tmp_path / "transforms_train.json").write_text(json.dumps(meta))
    got = ds.load_transforms(str(tmp_path / "transforms_train.json"))
    want = jds.load_transforms(str(tmp_path / "transforms_train.json"))
    for b, jb in zip(got[0], want[0]):
        _assert_bundles_equal(b, jb)
    np.testing.assert_array_equal(got[1][0], want[1][0])
    assert got[1][0].shape == (24, 32, 3) and got[1][1] is None and want[1][1] is None
    # the same frames render the same in both packages' oracles
    params = _scene(30, 2)
    from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
    from openglgaussiansplattingrenderer_tpu.render import render_arrays as jax_render
    b = got[0][0]
    mine, _ = render_arrays(convert.params_from_numpy(params, "cpu"), *_bundle_args(b),
                            32, 24, CFG)
    theirs, _ = jax_render({k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(b["view"]), jnp.asarray(b["vp"]),
                           *_bundle_args(b)[2:], 32, 24,
                           JaxConfig(use_pallas=False, chunk=32, max_per_tile=256,
                                     dup_capacity_factor=32.0))
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), atol=1e-4)
    assert float(torch.as_tensor(mine).max()) > 0
