"""The port's oracle pipeline (``render_arrays(use_pallas=False)``) against
the JAX package's oracle, on the CPU.

- image within 1e-4 (the ARCHITECTURE.md oracle contract) and every stats
  value exactly equal, on the scenes of ``tests/test_render_golden.py`` (a
  single splat at 256x256, a random scene at 128x128, a rotated camera at
  128x64), in the ``pair`` and ``reference`` depth-key modes;
- the port's oracle against the port's fast path (the kernels' plain
  versions on the CPU), image within 1e-4;
- torch autograd of ``render_loss`` against ``jax.grad``, every parameter
  tensor within 5e-3 of its largest gradient;
- the finite-difference check of ``tests/test_grad.py`` on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args
from openglgaussiansplattingrenderer_tpu.render import render_arrays as jax_render
from openglgaussiansplattingrenderer_tpu.render import render_loss as jax_render_loss

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays, render_loss
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = dict(use_pallas=False, max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)
SINGLE = dict(use_pallas=False, max_per_tile=256, chunk=64, dup_capacity_factor=256.0)


def _rotated_camera():
    cam = JaxCamera(1.0, 0.5, -5.0, width=128, height=64)
    cam.rotate_down(10.0)
    cam.rotate_right(15.0)
    cam.update()
    return cam


SCENES = {
    "single@256x256": (jax_ply.single_splat_scene,
                       lambda: JaxCamera(0.0, 0.0, -3.0, width=256, height=256),
                       SINGLE),
    "300@128x128": (lambda: jax_ply.make_synthetic_scene(300, seed=7, extent=2.0),
                    lambda: JaxCamera(0.0, 0.0, -6.0, width=128, height=128), BASE),
    "200@128x64 rotated": (
        lambda: jax_ply.make_synthetic_scene(200, seed=11, extent=2.0),
        _rotated_camera, BASE),
}


def _case(name):
    make, cam, opts = SCENES[name]
    scene = {k: v for k, v in make().items() if k != "sh_rest"}
    cam = cam()
    a = jax_camera_args(cam)
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], cam.width, cam.height)
    return scene, args, opts


def _jax(scene, args, cfg):
    img, stats = jax_render({k: jnp.asarray(v) for k, v in scene.items()},
                            jnp.asarray(args[0]), jnp.asarray(args[1]), *args[2:],
                            cfg)
    return np.asarray(img), {k: np.asarray(v).item() for k, v in stats.items()}


@pytest.mark.parametrize("depth_key", ["pair", "reference"])
@pytest.mark.parametrize("name", list(SCENES))
def test_oracle_matches_jax_oracle(name, depth_key):
    scene, args, opts = _case(name)
    img_j, st_j = _jax(scene, args, JaxConfig(depth_key=depth_key, **opts))
    img_t, st_t = render_arrays(params_from_numpy(scene, "cpu"), *args,
                                RenderConfig(depth_key=depth_key, **opts))
    assert img_j[..., 3].max() > 0.5
    assert img_t.shape == img_j.shape and img_t.dtype == torch.float32
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-4)
    assert {k: v.item() for k, v in st_t.items()} == st_j
    assert st_j["overflow"] == 0 and st_j["dropped_by_cap"] == 0


@pytest.mark.parametrize("name", list(SCENES))
def test_oracle_matches_fast_path(name):
    # the two pipelines of the port share preprocess and nothing after it
    scene, args, opts = _case(name)
    cfg = RenderConfig(**opts)
    params = params_from_numpy(scene, "cpu")
    img_o, st_o = render_arrays(params, *args, cfg)
    img_f, st_f = render_arrays(params, *args, dataclasses.replace(cfg, use_pallas=True))
    np.testing.assert_allclose(img_o.numpy(), img_f.numpy(), atol=1e-4)
    # the fast path culls unreachable records; the oracle keeps them
    assert int(st_o["num_records"]) >= int(st_f["num_records"])
    assert int(st_o["num_visible"]) == int(st_f["num_visible"])


def test_oracle_overflow_matches_jax():
    # a capacity below the record count drops the last records in splat
    # order, counted in overflow, as in JAX
    scene, args, _ = _case("300@128x128")
    opts = dict(BASE, dup_capacity_factor=2.0)
    img_j, st_j = _jax(scene, args, JaxConfig(**opts))
    img_t, st_t = render_arrays(params_from_numpy(scene, "cpu"), *args,
                                RenderConfig(**opts))
    assert st_j["overflow"] > 0
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-4)
    assert {k: v.item() for k, v in st_t.items()} == st_j


def _grad_scene():
    """tests/test_grad.py's scene: 20 splats at 64x64, opacities in [0.3, 0.7]."""
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(
        20, seed=5, extent=1.0).items() if k != "sh_rest"}
    scene["opacities"] = np.clip(scene["opacities"], 0.3, 0.7)
    a = jax_camera_args(JaxCamera(0.0, 0.0, -4.0, width=64, height=64))
    return scene, (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
                   a["tan_fovy"], 64, 64)


GRAD_OPTS = dict(use_pallas=False, max_per_tile=512, chunk=64)


def test_render_loss_grad_matches_jax_grad():
    scene, args = _grad_scene()
    target = np.full((64, 64, 3), 0.1, np.float32)
    want = jax.grad(lambda p: jax_render_loss(
        p, jnp.asarray(target), jnp.asarray(args[0]), jnp.asarray(args[1]),
        *args[2:], JaxConfig(**GRAD_OPTS)))(
        {k: jnp.asarray(v) for k, v in scene.items()})
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
    loss = render_loss(p, torch.as_tensor(target), *args, RenderConfig(**GRAD_OPTS))
    got = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for k, w in want.items():
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(got[k].numpy() - w).max() <= 5e-3 * scale, k


def test_oracle_grad_matches_finite_differences():
    """tests/test_grad.py::test_grad_matches_finite_differences on the port:
    the directional derivative along five random unit directions per
    parameter tensor, median within 15% of central differences."""
    scene, args = _grad_scene()
    cfg = RenderConfig(**GRAD_OPTS)
    target = torch.full((64, 64, 3), 0.1)

    def loss(p):
        return render_loss(p, target, *args, cfg)

    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
    grads = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
    rng = np.random.default_rng(0)
    f64 = {k: np.asarray(v, np.float64) for k, v in scene.items()}
    with torch.no_grad():
        for key, eps in [("colors", 1e-1), ("opacities", 1e-3), ("means", 1e-3),
                         ("scales", 1e-3), ("quats", 1e-3)]:
            g = grads[key].numpy().astype(np.float64)
            errs = []
            for _ in range(5):
                d = rng.normal(size=g.shape)
                d /= np.linalg.norm(d)
                want = float(np.sum(g * d))
                lp = float(loss(params_from_numpy(dict(f64, **{key: f64[key] + eps * d}),
                                                  "cpu")))
                lm = float(loss(params_from_numpy(dict(f64, **{key: f64[key] - eps * d}),
                                                  "cpu")))
                fd = (lp - lm) / (2 * eps)
                errs.append(abs(fd - want) / max(abs(want), abs(fd), 1e-6))
            assert np.sort(errs)[2] < 0.15, f"{key}: rel errs {np.sort(errs)}"
