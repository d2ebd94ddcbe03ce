"""The port's ``Splats`` facade: ``cpu_render``, ``render_camera_u8``,
``render_depth_camera`` and ``invalidate_cache``, on a PLY the test writes,
with ``device="cpu"`` (the kernels' plain versions and the oracle).

Mirrors ``tests/test_facade.py`` and ``tests/test_depth.py::
test_depth_facade`` (whose fixture PLY is absent here) on written scenes,
and holds ``cpu_render`` to the JAX facade's.
"""

import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu import Splats as JaxSplats

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.camera import default_camera
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.io.png import load_png
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_depth
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = dict(chunk=32, max_per_tile=256, dup_capacity_factor=24.0)


def _ply(tmp_path, n=60, seed=3):
    s = ply_io.make_synthetic_scene(n, seed=seed, extent=2.0)
    p = str(tmp_path / "scene.ply")
    ply_io.save_ply(p, s["means"], s["quats"], s["scales"], s["opacities"],
                    s["colors"])
    return p


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel path", "oracle"])
def test_default_resolution_vs_golden(tmp_path, use_pallas):
    """At the reference's 1024x512 default with its camera pose
    (main.cpp:40-45): the device frame against ``cpu_render``, and
    ``cpu_render`` against the JAX facade's."""
    path = _ply(tmp_path, n=40, seed=8)
    cfg = port.RenderConfig(use_pallas=use_pallas, **OPTS)
    s = port.Splats(path, 1024, 512, cfg=cfg, device="cpu")
    cam = default_camera()
    a = camera_args(cam)
    img = s.render_camera(cam)
    png = tmp_path / "cpuRender.png"
    gold = s.cpu_render(a["view"], 1024, 512, a["focal_x"], a["focal_y"],
                        a["tan_fovx"], a["tan_fovy"], a["vp"], save_path=str(png))
    assert img.shape == gold.shape == (512, 1024, 4)
    assert gold[..., 3].max() > 0.5
    np.testing.assert_allclose(img, gold, atol=4e-3)
    assert load_png(str(png)).shape[:2] == (512, 1024)
    gold_j = JaxSplats(path, 1024, 512, cfg=JaxConfig(use_pallas=use_pallas, **OPTS)
                       ).cpu_render(a["view"], 1024, 512, a["focal_x"], a["focal_y"],
                                    a["tan_fovx"], a["tan_fovy"], a["vp"],
                                    save_path=None)
    np.testing.assert_allclose(gold, gold_j, atol=1e-6)


def test_render_camera_u8(tmp_path):
    s = port.Splats(_ply(tmp_path), 128, 128, cfg=port.RenderConfig(**OPTS),
                    device="cpu")
    cam = port.Camera(0.0, 0.0, -5.0, width=128, height=128)
    u8 = s.render_camera_u8(cam)
    assert u8.dtype == np.uint8 and u8.shape == (128, 128, 3)
    img = s.render_camera(cam)
    want = (np.clip(img[..., :3], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(u8, want)
    assert u8.max() > 100
    s.last_stats = None
    s.render_camera_u8(cam, fetch_stats=False)
    assert s.last_stats is None
    s.render_camera_u8(cam)
    assert int(s.last_stats["overflow"]) == 0 and int(s.last_stats["num_splats"]) == 60


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel path", "oracle"])
def test_render_depth_camera(tmp_path, use_pallas):
    cfg = port.RenderConfig(use_pallas=use_pallas, **OPTS)
    s = port.Splats(_ply(tmp_path), 128, 128, cfg=cfg, device="cpu")
    cam = port.Camera(0.0, 0.0, -5.0, width=128, height=128)
    depth, alpha = s.render_depth_camera(cam)
    assert depth.shape == (128, 128) and alpha.shape == (128, 128)
    assert alpha.max() > 0.5 and np.isfinite(depth).all()
    assert int(s.last_stats["overflow"]) == 0
    a = camera_args(cam)
    d, al, _ = render_depth(params_from_numpy(
        {k: getattr(s.scene, k) for k in ("means", "scales", "quats", "opacities",
                                          "colors")}, "cpu"),
        a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
        a["tan_fovy"], 128, 128, cfg, mode="view")
    d_view, al_view = s.render_depth_camera(cam, mode="view")
    np.testing.assert_allclose(d_view, d.numpy(), atol=1e-4)
    np.testing.assert_allclose(al_view, al.numpy(), atol=1e-5)
    np.testing.assert_allclose(al_view, alpha, atol=1e-6)


def test_invalidate_cache(tmp_path):
    s = port.Splats(_ply(tmp_path), 128, 128, cfg=port.RenderConfig(**OPTS),
                    device="cpu")
    cam = port.Camera(0.0, 0.0, -5.0, width=128, height=128)
    before = s.render_camera(cam).copy()
    s.scene.colors = np.zeros_like(s.scene.colors)
    s.scene.scales = s.scene.scales * 0.5
    # the device copy was uploaded at construction: the mutation does not show
    np.testing.assert_array_equal(s.render_camera(cam), before)
    s.invalidate_cache()
    after = s.render_camera(cam)
    assert np.abs(after[..., :3]).max() == 0.0
    assert not np.array_equal(after[..., 3], before[..., 3])
    # the covariances were uploaded anew too: as a fresh facade on the scene
    want = port.Splats.__new__(port.Splats)
    want.scene, want.device = s.scene, torch.device("cpu")
    want.invalidate_cache()
    assert torch.equal(s._params["cov6"], want._params["cov6"])
