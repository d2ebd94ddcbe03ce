"""The port's sharded fast path (``parallel/fast_sharded.py``) on CPU meshes
(every kernel wrapper takes its plain version), against the port's own
single-device fast path and against the JAX package's
``parallel/fast_sharded.py`` on conftest's 8 virtual CPU devices (Pallas in
interpret mode, jitted).

Tolerances: against the port's single-device path, the JAX tests' own
(frames 1e-5; gradients rtol 1e-4 / atol 1e-7; the sharded gs loss within
1e-6 of the single-device one); against the JAX function, the contracts
(frames 1e-4, so losses 1e-4; gradients within 5e-3 of each tensor's
largest ``jax.grad`` gradient; the record, exchange and overflow counts
exactly); q16 within 2e-3 of the f32 frame and of the single-device q16
frame, as the JAX test holds it.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.parallel import fast_sharded as jfs
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args
from openglgaussiansplattingrenderer_tpu.train import losses as jlosses
from openglgaussiansplattingrenderer_tpu.train import trainer as jtrainer

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs
from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import gather_shards
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train import losses
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
    TrainConfig,
    make_optimizer,
    params_from_raw,
    raw_from_params,
)
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = dict(chunk=32, dup_capacity_factor=16.0)
CFG = port.RenderConfig(**OPTS)
W = H = 64
TC = TrainConfig(lambda_dssim=0.2)


def _scene(n, seed, extent=1.5, sh=False):
    s = jax_ply.make_synthetic_scene(n, seed=seed, extent=extent)
    s = {k: v for k, v in s.items() if k != "sh_rest"}
    if sh:
        s["sh_rest"] = np.random.default_rng(4).normal(0, 10.0, (n, 45)).astype(np.float32)
    return s


def _args():
    a = camera_args(port.Camera(0.0, 0.0, -4.0, width=W, height=H))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"])


def _jax_args():
    a = jax_camera_args(JaxCamera(0.0, 0.0, -4.0, width=W, height=H))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"])


def _mesh(n):
    return fs.make_mesh(devices=["cpu"] * n)


def _target():
    return np.random.default_rng(2).uniform(0, 1, (H, W, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_frame(n, seed, ndev, exch_factor=2.0, extent=1.5, sh=False, **opts):
    """The JAX sharded frame and its stats (host arrays)."""
    scene = {k: jnp.asarray(v) for k, v in _scene(n, seed, extent, sh).items()}
    cfg = JaxConfig(**dict(OPTS, **opts))
    mesh = jfs.make_mesh(ndev)
    img, stats = jax.jit(lambda p: jfs.render_fast_sharded(
        p, *_jax_args(), W, H, cfg, mesh, exch_factor=exch_factor))(scene)
    return np.asarray(img), {k: int(v) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def _jax_gs_step():
    """(loss, stats, raw gradients) of the gs loss through the JAX sharded
    render on 8 devices, as ``train_step_fast_sharded`` takes them."""
    scene = {k: jnp.asarray(v) for k, v in _scene(64, 9).items()}
    mesh = jfs.make_mesh(8)
    target = jnp.asarray(_target())

    def loss_fn(raw):
        img, stats = jfs.render_fast_sharded(
            jtrainer.params_from_raw(raw), *_jax_args(), W, H, JaxConfig(**OPTS), mesh)
        return jlosses.gs_loss(img[..., :3], target, 0.2), stats

    (loss, stats), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jtrainer.raw_from_params(scene))
    return (float(loss), {k: int(v) for k, v in stats.items()},
            {k: np.asarray(v) for k, v in g.items()})


def _grads(loss_of_params, scene, raw_space=False):
    p = params_from_numpy(scene, "cpu")
    if raw_space:
        p = raw_from_params(p)
    p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    loss = loss_of_params(params_from_raw(p) if raw_space else p)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


@pytest.mark.parametrize("ndev", [2, 8])
def test_fast_sharded_render_matches_single_and_jax(ndev):
    scene = _scene(96, 3)
    params = params_from_numpy(scene, "cpu")
    before = (ks.cumsum.launches, kc.composite.launches)
    img, stats = fs.render_fast_sharded(params, *_args(), W, H, CFG, _mesh(ndev))
    assert (ks.cumsum.launches, kc.composite.launches) == before, "launched on the CPU"
    single, stats_1 = render_arrays(params, *_args(), W, H, CFG)
    assert int(stats["overflow"]) == 0
    assert int(stats["num_records"]) == int(stats_1["num_records"])
    assert float(img[..., 3].max()) > 0.1, "the frame shows nothing"
    assert float((img - single).abs().max()) <= 1e-5
    want, want_stats = _jax_frame(96, 3, ndev)
    np.testing.assert_allclose(img.numpy(), want, atol=1e-4)
    assert {k: int(v) for k, v in stats.items()} == want_stats


def test_fast_sharded_grads_match_single():
    scene = _scene(64, 9)

    def mse(img):
        return torch.mean((img[..., :3] - 0.15) ** 2)

    _, g_s = _grads(lambda p: mse(fs.render_fast_sharded(
        p, *_args(), W, H, CFG, _mesh(8))[0]), scene)
    _, g_1 = _grads(lambda p: mse(render_arrays(p, *_args(), W, H, CFG)[0]), scene)
    for k in g_1:
        assert float(g_1[k].abs().max()) > 0, k
        np.testing.assert_allclose(g_s[k].numpy(), g_1[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_train_step_fast_sharded_trains_gs_objective():
    """The sharded step's loss is the single-device gs loss; its gradients
    are the single-device ones and JAX's; its update is the port's Adam of
    them (where the gradient's sign is settled, JAX's update too)."""
    import optax

    scene = _scene(64, 9)
    target = torch.from_numpy(_target())

    def gs(p, render):
        return losses.gs_loss(render(p)[..., :3], target, 0.2)

    l_s, g_s = _grads(lambda p: gs(p, lambda q: fs.render_fast_sharded(
        q, *_args(), W, H, CFG, _mesh(8))[0]), scene, raw_space=True)
    l_1, g_1 = _grads(lambda p: gs(p, lambda q: render_arrays(
        q, *_args(), W, H, CFG)[0]), scene, raw_space=True)
    assert abs(l_s - l_1) < 1e-6
    want_loss, want_stats, want_g = _jax_gs_step()
    assert abs(l_s - want_loss) <= 1e-4
    for k, w in want_g.items():
        np.testing.assert_allclose(g_s[k].numpy(), g_1[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(g_s[k].numpy() - w).max() <= 5e-3 * scale, k

    # the step itself
    mesh = _mesh(8)
    optimizer = make_optimizer(TC)
    raw = raw_from_params(params_from_numpy(scene, "cpu"))
    shards = fs.shard_params(raw, mesh)
    raw2, opt2, loss, stats = fs.train_step_fast_sharded(
        shards, [optimizer.init(s) for s in shards], target, *_args(), width=W,
        height=H, cfg=CFG, mesh=mesh, optimizer=optimizer, lambda_dssim=0.2)
    assert abs(float(loss) - l_s) <= 1e-7
    assert {k: int(v) for k, v in stats.items()} == want_stats
    assert want_stats["overflow"] == 0 and want_stats["num_records"] > 0
    got = gather_shards(raw2, "cpu")
    stepped, _ = optimizer.update(g_s, optimizer.init(raw), raw)
    j_raw = jtrainer.raw_from_params({k: jnp.asarray(v) for k, v in scene.items()})
    j_opt = jtrainer.make_optimizer(TC)
    j_up, _ = j_opt.update({k: jnp.asarray(v) for k, v in want_g.items()},
                           j_opt.init(j_raw), j_raw)
    j_raw2 = optax.apply_updates(j_raw, j_up)
    for k in raw:
        np.testing.assert_allclose(got[k].numpy(), stepped[k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        settled = np.abs(want_g[k]) > 1e-2 * np.abs(want_g[k]).max()
        np.testing.assert_allclose(got[k].numpy()[settled],
                                   np.asarray(j_raw2[k])[settled], atol=1e-6,
                                   err_msg=k)
        assert bool(torch.isfinite(got[k]).all()), k
    qn = torch.linalg.vector_norm(params_from_raw(got)["quats"], dim=-1)
    assert float((qn - 1.0).abs().max()) < 1e-5
    assert all(o["count"] == 1 for o in opt2)


def test_sharded_overflow_surfaces_warns_and_zero_drop():
    """A tight clump of splats over a few tiles: with tiny buckets the
    clumped owner overflows, the stats say so (as many records as JAX
    drops) and the warning fires; exch_factor = D gives the single-device
    frame."""
    ndev = 8
    scene = _scene(4096, 11, extent=0.05)
    params = params_from_numpy(scene, "cpu")
    mesh = _mesh(ndev)
    img_of, stats_of = fs.render_fast_sharded(params, *_args(), W, H, CFG, mesh,
                                              exch_factor=0.05)
    want_img, want_stats = _jax_frame(4096, 11, ndev, exch_factor=0.05, extent=0.05)
    assert {k: int(v) for k, v in stats_of.items()} == want_stats
    assert want_stats["overflow"] > 0
    np.testing.assert_allclose(img_of.numpy(), want_img, atol=1e-4)
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        ov = fs.warn_on_sharded_overflow(stats_of, 0.05, ndev)
    assert ov == want_stats["overflow"]
    assert any("dropped" in str(w.message) for w in wlist)

    img_full, stats_full = fs.render_fast_sharded(params, *_args(), W, H, CFG, mesh,
                                                  exch_factor=float(ndev))
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        assert fs.warn_on_sharded_overflow(stats_full, 8.0, ndev) == 0
    assert not wlist
    single, _ = render_arrays(params, *_args(), W, H, CFG)
    assert float((img_full - single).abs().max()) <= 1e-5
    # the overflowed render differs: records were really dropped
    assert float((img_of - single).abs().max()) > 1e-3


def test_fast_sharded_q16_inside_tolerance():
    scene = _scene(512, 21)
    params = params_from_numpy(scene, "cpu")
    mesh = _mesh(4)
    q16 = dict(sort_payload="q16", depth_key="packed")
    cfg_q = port.RenderConfig(**OPTS, **q16)
    img_f, stats_f = fs.render_fast_sharded(params, *_args(), W, H, CFG, mesh)
    img_q, stats_q = fs.render_fast_sharded(params, *_args(), W, H, cfg_q, mesh)
    assert int(stats_f["overflow"]) == int(stats_q["overflow"]) == 0
    assert int(stats_q["num_records"]) == int(stats_f["num_records"])
    err = float((img_q[..., :3] - img_f[..., :3]).abs().max())
    assert 0.0 < err < 2e-3, err
    single_q, _ = render_arrays(params, *_args(), W, H, cfg_q)
    assert float((img_q - single_q).abs().max()) <= 2e-3
    want, want_stats = _jax_frame(512, 21, 4, **q16)
    np.testing.assert_allclose(img_q.numpy(), want, atol=1e-4)
    assert {k: int(v) for k, v in stats_q.items()} == want_stats


def test_fast_sharded_q16_backward_raises():
    scene = _scene(64, 5)
    cfg_q = dataclasses.replace(CFG, sort_payload="q16")
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
    img, _ = fs.render_fast_sharded(p, *_args(), W, H, cfg_q, _mesh(4))
    assert img.requires_grad
    with pytest.raises(NotImplementedError, match="inference-only"):
        torch.autograd.grad(img[..., :3].mean(), list(p.values()))


def test_fast_sharded_sh_colors_match_single_and_jax():
    scene = _scene(96, 13, sh=True)
    params = params_from_numpy(scene, "cpu")
    cfg_sh = dataclasses.replace(CFG, sh_degree=1)
    img, stats = fs.render_fast_sharded(params, *_args(), W, H, cfg_sh, _mesh(4))
    single, _ = render_arrays(params, *_args(), W, H, cfg_sh)
    assert int(stats["overflow"]) == 0
    assert float((img - single).abs().max()) <= 1e-5
    dc_only, _ = render_arrays(params, *_args(), W, H, CFG)
    assert float((single - dc_only).abs().max()) > 1e-3, "SH made no difference"
    want, _ = _jax_frame(96, 13, 4, sh=True, sh_degree=1)
    np.testing.assert_allclose(img.numpy(), want, atol=1e-4)


def test_exchange_capacity_matches_jax():
    for n_local, ndev, f in ((12, 8, 2.0), (5000, 4, 4.0), (123_457, 4, 0.05)):
        assert fs.exchange_capacity(CFG, n_local, ndev, f) == jfs.exchange_capacity(
            JaxConfig(**OPTS), n_local, ndev, f)
