"""Expected-depth rendering (``render.render_depth``) of the port.

Mirrors the first four tests of ``tests/test_depth.py``: the kernel path
(the kernels' plain versions on the CPU) against the oracle, the analytic
value on a single splat, the order of two stacked splats, and gradients.
Each also holds the port's maps to the JAX package's ``render_depth`` on
the same pipeline: depth within 1e-4, alpha within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.render import camera_args
from openglgaussiansplattingrenderer_tpu.render import render_depth as jax_render_depth

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.render import render_depth
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = H = 128
FAST = dict(use_pallas=True, chunk=64, dup_capacity_factor=16.0)
ORACLE = dict(FAST, use_pallas=False, max_per_tile=512)


def _args(z):
    a = camera_args(JaxCamera(0.0, 0.0, z, width=W, height=H))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], W, H)


def _both(scene, args, opts, **kw):
    """(port depth, port alpha, JAX depth, JAX alpha) as numpy."""
    d, a, _ = render_depth(params_from_numpy(scene, "cpu"), *args,
                           RenderConfig.for_resolution(W, H, tile_px=32, **opts), **kw)
    dj, aj, _ = jax_render_depth(
        {k: jnp.asarray(v) for k, v in scene.items()}, jnp.asarray(args[0]),
        jnp.asarray(args[1]), *args[2:],
        JaxConfig.for_resolution(W, H, tile_px=32, **opts), **kw)
    return d.numpy(), a.numpy(), np.asarray(dj), np.asarray(aj)


def _scene(n, seed, extent):
    return {k: v for k, v in jax_ply.make_synthetic_scene(
        n, seed=seed, extent=extent).items() if k != "sh_rest"}


def _port(scene, args, opts, **kw):
    d, a, _ = render_depth(params_from_numpy(scene, "cpu"), *args,
                           RenderConfig.for_resolution(W, H, tile_px=32, **opts), **kw)
    return d.numpy(), a.numpy()


@pytest.mark.parametrize("mode", ["ndc", "view"])
def test_depth_kernel_path_matches_oracle(mode):
    scene, args = _scene(300, 5, 2.5), _args(-6.0)
    d_o, a_o, dj_o, aj_o = _both(scene, args, ORACLE, mode=mode)
    if mode == "ndc":
        # the JAX fast path runs its Pallas kernels in interpret mode: once
        d_p, a_p, dj_p, aj_p = _both(scene, args, FAST, mode=mode)
        np.testing.assert_allclose(d_p, dj_p, atol=1e-4)
        np.testing.assert_allclose(a_p, aj_p, atol=1e-5)
    else:
        d_p, a_p = _port(scene, args, FAST, mode=mode)
    assert a_o.max() > 0.5
    np.testing.assert_allclose(d_p, d_o, atol=1e-4)
    np.testing.assert_allclose(a_p, a_o, atol=1e-5)
    np.testing.assert_allclose(d_o, dj_o, atol=1e-4)
    np.testing.assert_allclose(a_o, aj_o, atol=1e-5)


def test_depth_single_splat_analytic():
    """One splat: every covered pixel's normalized depth is the splat's own
    depth (sum w d / sum w == d). A second splat far off to the side is
    culled (it gives the JAX side the shapes of the two-splat test)."""
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(
        2, seed=0, extent=0.0).items() if k != "sh_rest"}
    scene["means"] = np.array([[0.0, 0.0, 0.0], [100.0, 0.0, 0.0]], np.float32)
    scene["opacities"] = np.array([0.9, 0.9], np.float32)
    args = _args(-3.0)
    for mode in ("ndc", "view"):
        depth, alpha, dj, aj = _both(scene, args, ORACLE, mode=mode)
        covered = alpha > 1e-3
        assert covered.sum() > 50
        vals = depth[covered]
        assert np.ptp(vals) < 1e-4, (mode, float(np.ptp(vals)))
        p = np.asarray(args[1 if mode == "ndc" else 0], np.float32) @ np.array(
            [0, 0, 0, 1], np.float32)
        expect = (p[2] / p[3] + 1) / 2 if mode == "ndc" else p[2]
        np.testing.assert_allclose(vals.mean(), expect, atol=1e-4)
        np.testing.assert_allclose(depth, dj, atol=1e-4)
        np.testing.assert_allclose(alpha, aj, atol=1e-5)


def test_depth_ordering_two_splats():
    """The nearer of two stacked opaque splats dominates the blended depth."""
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(
        2, seed=0, extent=0.0).items() if k != "sh_rest"}
    scene["means"] = np.array([[0, 0, -1.0], [0, 0, 1.0]], np.float32)
    scene["opacities"] = np.array([0.95, 0.95], np.float32)
    args = _args(-4.0)
    depth, _, dj, _ = _both(scene, args, ORACLE, mode="ndc")
    c = depth[H // 2, W // 2]
    vp = np.asarray(args[1], np.float32)

    def z(m):
        p = vp @ np.array([*m, 1], np.float32)
        return float((p[2] / p[3] + 1) / 2)

    # the reference camera's view quirk decides which world z is nearer:
    # take it from the NDC values, the sort's own order
    z_near, z_far = sorted((z([0, 0, -1.0]), z([0, 0, 1.0])))
    assert z_near - 1e-5 <= c <= z_far
    assert abs(c - z_near) < 0.25 * (z_far - z_near)
    np.testing.assert_allclose(depth, dj, atol=1e-4)


@pytest.mark.parametrize("opts", [FAST, ORACLE], ids=["kernel path", "oracle"])
def test_depth_differentiable(opts):
    scene, args = _scene(300, 5, 2.5), _args(-6.0)
    cfg = RenderConfig.for_resolution(W, H, tile_px=32, **opts)
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
    depth, _, _ = render_depth(p, *args, cfg, normalize=False)
    # the colours do not reach a depth map: their gradient is zero
    got = dict(zip(p, torch.autograd.grad((depth ** 2).mean(), list(p.values()),
                                          materialize_grads=True)))
    assert not got["colors"].any()
    for k, g in got.items():
        assert bool(torch.isfinite(g).all()), k
    assert float(got["means"].abs().max()) > 0.0
    # the map that was differentiated is the JAX package's
    _, _, dj, _ = _both(scene, args, ORACLE, normalize=False)
    np.testing.assert_allclose(depth.detach().numpy(), dj, atol=1e-4)


def test_depth_rejects_unknown_mode():
    scene, args = _scene(4, 1, 1.0), _args(-4.0)
    with pytest.raises(ValueError, match="depth mode"):
        render_depth(params_from_numpy(scene, "cpu"), *args,
                     RenderConfig(**ORACLE), mode="world")
