"""The port's mesh, collectives and sharded oracle (``parallel/sharded.py``)
on CPU meshes, against the JAX package's ``parallel/sharded.py`` on
conftest's 8 virtual CPU devices.

Tolerances: the collectives' layouts equal ``jax.lax.all_gather`` /
``all_to_all`` (tiled) exactly, and their transposes pass
``torch.autograd.gradcheck`` in float64; ``pad_scene_for_mesh`` equals the
JAX function's arrays; the sharded oracle frame within 1e-4 of the JAX
``render_sharded`` frame (the frame contract) and within 1e-5 of the port's
single-device oracle frame (the JAX test's own limit); its gradients within
5e-3 of each tensor's largest ``jax.grad`` gradient, and within rtol 1e-4 /
atol 1e-7 of the single-device gradients (the JAX test's limits).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.parallel import sharded as jsharded
from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.parallel import sharded
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
    TrainConfig,
    make_optimizer,
    raw_from_params,
)
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = dict(use_pallas=False, chunk=32, max_per_tile=512, dup_capacity_factor=16.0)
CFG = port.RenderConfig(**OPTS)
W = H = 64


def _scene(n, seed):
    s = jax_ply.make_synthetic_scene(n, seed=seed, extent=1.5)
    return {k: v for k, v in s.items() if k != "sh_rest"}


def _args():
    a = camera_args(port.Camera(0.0, 0.0, -4.0, width=W, height=H))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"])


def _jax_args():
    a = jax_camera_args(JaxCamera(0.0, 0.0, -4.0, width=W, height=H))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"])


def _cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


@functools.lru_cache(maxsize=None)
def _jax_frame(n, seed, ndev):
    scene = {k: jnp.asarray(v) for k, v in _scene(n, seed).items()}
    mesh = jsharded.make_mesh(ndev)
    fn = jax.jit(lambda p: jsharded.render_sharded(
        p, *_jax_args(), W, H, JaxConfig(**OPTS), mesh))
    return np.asarray(fn(scene))


def _mse(img):
    return torch.mean((img[..., :3] - 0.15) ** 2)


@functools.lru_cache(maxsize=None)
def _jax_grads():
    scene = {k: jnp.asarray(v) for k, v in _scene(64, 9).items()}
    mesh = jsharded.make_mesh(8)

    def loss(p):
        img = jsharded.render_sharded(p, *_jax_args(), W, H, JaxConfig(**OPTS), mesh)
        return jnp.mean((img[..., :3] - 0.15) ** 2)

    return {k: np.asarray(v) for k, v in jax.jit(jax.grad(loss))(scene).items()}


def test_make_mesh_takes_devices_and_refuses_missing_cuda():
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.shape == {"dev": 3}
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        sharded.make_mesh(2, devices=["cpu"] * 3)
    # no CUDA device here: a mesh of CUDA devices cannot be made
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices asked for"):
        sharded.make_mesh(n + 1)


def test_collective_layouts_match_jax():
    ndev = 4
    x = np.arange(ndev * 8 * 3, dtype=np.float32).reshape(ndev * 8, 3)
    mesh_j = jsharded.make_mesh(ndev)
    a2a = jax.jit(jsharded.shard_map(
        lambda v: jax.lax.all_to_all(v, "dev", 0, 0, tiled=True), mesh_j,
        in_specs=(P("dev"),), out_specs=P("dev")))(jnp.asarray(x))
    gather = jax.jit(jsharded.shard_map(
        lambda v: jax.lax.all_gather(v, "dev", axis=0, tiled=True), mesh_j,
        in_specs=(P("dev"),), out_specs=P("dev")))(jnp.asarray(x))
    total = jax.jit(jsharded.shard_map(
        lambda v: jax.lax.psum(v, "dev"), mesh_j,
        in_specs=(P("dev"),), out_specs=P("dev")))(jnp.asarray(x))

    mesh = _cpu_mesh(ndev)
    xs = list(torch.from_numpy(x).chunk(ndev))
    np.testing.assert_array_equal(torch.cat(sharded.all_to_all(xs, mesh)).numpy(),
                                  np.asarray(a2a))
    np.testing.assert_array_equal(torch.cat(sharded.all_gather(xs, mesh)).numpy(),
                                  np.asarray(gather))
    np.testing.assert_array_equal(torch.cat(sharded.psum(xs, mesh)).numpy(),
                                  np.asarray(total))
    np.testing.assert_array_equal(torch.cat(sharded.pmean(xs, mesh)).numpy(),
                                  np.asarray(total) / ndev)
    with pytest.raises(ValueError, match="blocks"):
        sharded.all_to_all([torch.zeros(5)] * ndev, mesh)


@pytest.mark.parametrize("name", ["all_gather", "all_to_all", "psum"])
def test_collective_transposes_gradcheck(name):
    mesh = _cpu_mesh(3)
    fn = getattr(sharded, name)
    rng = np.random.default_rng(3)
    xs = [torch.tensor(rng.normal(size=(6, 2)), dtype=torch.float64,
                       requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(lambda *v: tuple(fn(list(v), mesh)), xs)


def test_pad_scene_for_mesh_matches_jax():
    scene = _scene(13, 3)
    got = sharded.pad_scene_for_mesh(params_from_numpy(scene, "cpu"), 8)
    want = jsharded.pad_scene_for_mesh({k: jnp.asarray(v) for k, v in scene.items()}, 8)
    assert got["means"].shape[0] == 16
    assert np.all(got["opacities"][13:].numpy() == 0.0)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    same = sharded.pad_scene_for_mesh(got, 8)
    assert same is got
    shards = sharded.shard_params(got, _cpu_mesh(4))
    assert [s["means"].shape[0] for s in shards] == [4] * 4
    with pytest.raises(ValueError, match="pad_scene_for_mesh"):
        sharded.shard_params(params_from_numpy(scene, "cpu"), _cpu_mesh(4))


@pytest.mark.parametrize("ndev", [2, 8])
def test_render_sharded_matches_jax_and_single(ndev):
    scene = _scene(96, 3)
    params = params_from_numpy(scene, "cpu")
    img = sharded.render_sharded(params, *_args(), W, H, CFG, _cpu_mesh(ndev))
    single, _ = render_arrays(params, *_args(), W, H, CFG)
    assert float(img[..., 3].max()) > 0.1, "the frame shows nothing"
    assert float((img - single).abs().max()) <= 1e-5
    np.testing.assert_allclose(img.numpy(), _jax_frame(96, 3, ndev), atol=1e-4)


def test_sharded_gradients_match_jax_grad_and_single():
    scene = _scene(64, 9)
    mesh = _cpu_mesh(8)

    def grads(render):
        p = {k: v.requires_grad_(True) for k, v in params_from_numpy(scene, "cpu").items()}
        return dict(zip(p, torch.autograd.grad(_mse(render(p)), list(p.values()))))

    g_s = grads(lambda p: sharded.render_sharded(p, *_args(), W, H, CFG, mesh))
    g_1 = grads(lambda p: render_arrays(p, *_args(), W, H, CFG)[0])
    want = _jax_grads()
    for k, w in want.items():
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(g_s[k].numpy() - w).max() <= 5e-3 * scale, k
        np.testing.assert_allclose(g_s[k].numpy(), g_1[k].numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_sharded_train_step_applies_adam_to_the_sharded_gradients():
    scene = _scene(64, 9)
    mesh = _cpu_mesh(4)
    tc = TrainConfig()
    optimizer = make_optimizer(tc)
    raw = raw_from_params(params_from_numpy(scene, "cpu"))
    shards = sharded.shard_params(raw, mesh)
    opt = [optimizer.init(s) for s in shards]
    target = torch.full((H, W, 3), 0.15)
    new_raw, new_opt, loss = sharded.sharded_train_step(
        shards, opt, target, *_args(), width=W, height=H, cfg=CFG, mesh=mesh,
        optimizer=optimizer)

    # the same step by hand: the loss of the gathered parameters' sharded
    # frame, its gradients, one Adam update of the whole tensors
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import params_from_raw

    leaves = {k: v.clone().requires_grad_(True) for k, v in raw.items()}
    img = sharded.render_sharded(params_from_raw(leaves), *_args(), W, H, CFG, mesh)
    want_loss = _mse(img)
    g = dict(zip(leaves, torch.autograd.grad(want_loss, list(leaves.values()))))
    stepped, state = optimizer.update(g, optimizer.init(raw), raw)
    assert abs(float(loss) - float(want_loss.detach())) <= 1e-7
    got = sharded.gather_shards(new_raw, "cpu")
    for k in raw:
        np.testing.assert_allclose(got[k].numpy(), stepped[k].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    assert all(s["count"] == 1 for s in new_opt) and state["count"] == 1
    single, _ = render_arrays(params_from_numpy(scene, "cpu"), *_args(), W, H, CFG)
    assert abs(float(loss) - float(_mse(single))) <= 1e-6
