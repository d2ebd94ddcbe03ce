"""The port's 2-D (view x splat) mesh against the JAX package's
``parallel/mesh2d.py`` on the CPU: one 2-D train step on a (2, 2) mesh
(conftest's 8 virtual CPU devices on the JAX side, four repeated CPU
devices on the port's; the JAX fast path runs Pallas in interpret mode, so
its step is jitted once and cached), and the halo helpers on one image.

Tolerances: the update rtol 2e-4 / atol 1e-6 and the loss within 1e-4, as
``test_torch_data_parallel.py`` holds the dp step to JAX's; PSNR within
1e-2 dB; the densify statistic within 5e-3 of its largest value (the
gradient contract) after scaling JAX's by the batch (the JAX 2-D step norms
the shift gradient of the batch-mean loss, 1/B of each view's own; the
port sums the views' own statistics, as both packages' data-parallel steps
do), the seen counts exactly; the halo helpers exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.parallel import mesh2d as jm2
from openglgaussiansplattingrenderer_tpu.parallel.sharded import (
    pad_scene_for_mesh as jax_pad,
)
from openglgaussiansplattingrenderer_tpu.train import trainer as jtrainer

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.parallel import mesh2d
from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import pad_scene_for_mesh
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
    TrainConfig,
    camera_bundles,
    raw_from_params,
)
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = H = 32
OPTS = dict(grid_x=2, grid_y=2, chunk=32, dup_capacity_factor=8.0, max_per_tile=256)
BATCH = 2


def _setup():
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(48, seed=7, extent=1.5).items()
             if k != "sh_rest"}
    rng = np.random.default_rng(8)
    targets = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in range(BATCH)]
    return scene, targets


def _cams(camera):
    return [camera(0.4 * i - 0.6, 0.2, -4.0 - 0.3 * i, width=W, height=H)
            for i in range(BATCH)]


@functools.lru_cache(maxsize=None)
def _jax_step():
    """JAX's (2, 2) step with the densify statistic, on ``_setup``: (raw
    after, loss, psnr, overflow, gnorm, seen) as host arrays."""
    scene, targets = _setup()
    raw = jtrainer.raw_from_params(jax_pad({k: jnp.asarray(v) for k, v in scene.items()}, 4))
    keys = tuple(sorted(raw))
    cfg = JaxConfig(**OPTS)
    mesh = jm2.make_mesh2d(2, 2)
    step = jm2.make_2d_train_step(cfg, jtrainer.TrainConfig(lambda_dssim=0.2), W, H, mesh,
                                  batch=BATCH, param_keys=keys, with_grad_norms=True)
    bundles = jtrainer.camera_bundles(_cams(JaxCamera))
    tgt = jnp.stack([jnp.asarray(jm2.tile_target(t, W, H, cfg)[0]) for t in targets])
    sc = [jnp.stack([jnp.asarray(b[i], jnp.float32) for b in bundles]) for i in (2, 3, 4, 5)]
    raw_s = jm2.shard_raw_2d(raw, mesh)
    out = step(raw_s, step.init(raw_s), tgt, jnp.stack([b[0] for b in bundles]),
               jnp.stack([b[1] for b in bundles]), *sc)
    return ({k: np.asarray(v) for k, v in out[0].items()},
            *(np.asarray(v) for v in out[2:]))


def test_2d_step_matches_jax():
    scene, targets = _setup()
    cfg = port.RenderConfig(**OPTS)
    raw = raw_from_params(pad_scene_for_mesh(params_from_numpy(scene, "cpu"), 4))
    keys = tuple(sorted(raw))
    mesh = mesh2d.make_mesh2d(2, 2, devices=["cpu"] * 4)
    step = mesh2d.make_2d_train_step(cfg, TrainConfig(lambda_dssim=0.2), W, H, mesh,
                                     batch=BATCH, param_keys=keys, with_grad_norms=True)
    bundles = camera_bundles(_cams(port.Camera), "cpu")
    for t in targets:
        got_t, got_m = mesh2d.tile_target(t, W, H, cfg)
        want_t, want_m = jm2.tile_target(t, W, H, JaxConfig(**OPTS))
        np.testing.assert_array_equal(got_t, want_t)
        np.testing.assert_array_equal(got_m, want_m)
    tgt = torch.stack([torch.from_numpy(mesh2d.tile_target(t, W, H, cfg)[0]) for t in targets])
    rs = mesh2d.shard_raw_2d(raw, mesh)
    new_raw, _, loss, psnr, over, gnorm, seen = step(
        rs, step.init(rs), tgt, torch.stack([b[0] for b in bundles]),
        torch.stack([b[1] for b in bundles]),
        *(torch.tensor([float(b[j]) for b in bundles]) for j in (2, 3, 4, 5)))
    want_raw, want_loss, want_psnr, want_over, want_gnorm, want_seen = _jax_step()
    assert int(over) == int(want_over) == 0
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    assert abs(float(psnr) - float(want_psnr)) <= 1e-2
    got = mesh2d.gather_raw_2d(new_raw, "cpu")
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want_raw[k], rtol=2e-4, atol=1e-6,
                                   err_msg=f"2d update vs JAX for {k}")
    want_gnorm = want_gnorm * BATCH
    assert want_gnorm.max() > 0
    assert np.abs(gnorm.numpy() - want_gnorm).max() <= 5e-3 * want_gnorm.max()
    np.testing.assert_array_equal(seen.numpy(), want_seen)


@pytest.mark.parametrize("w,h,gx,gy", [(32, 32, 4, 4), (34, 30, 2, 2)])
def test_halo_helpers_match_jax(w, h, gx, gy):
    """``_padded_tiles`` (strips in global and in owner-major order) and
    ``_window_mask`` equal JAX's exactly, also where the tiles do not
    divide the image."""
    cfg_j = JaxConfig(grid_x=gx, grid_y=gy)
    cfg = port.RenderConfig(grid_x=gx, grid_y=gy)
    img = np.random.default_rng(3).uniform(0, 1, (h, w, 3)).astype(np.float32)
    tiles_np, _ = jm2.tile_target(img, w, h, cfg_j)
    t = gx * gy
    ph, pw = -(-h // gy), -(-w // gx)
    tiles4 = tiles_np.reshape(t, ph, pw, 3)
    owners = 2
    tpd = t // owners
    order = np.concatenate([e + owners * np.arange(tpd) for e in range(owners)])
    for d in range(owners):
        mine = d + owners * np.arange(tpd, dtype=np.int32)
        for layout, strips_src, row_of in (
                ("global", tiles4, lambda t2: t2),
                ("owner_major", tiles4[order], lambda t2: (t2 % owners) * tpd + t2 // owners)):
            want = jm2._padded_tiles(jnp.asarray(tiles4[mine]),
                                     jm2._tile_strips(jnp.asarray(strips_src)),
                                     jnp.asarray(mine), gx, gy, row_of)
            got = mesh2d._padded_tiles(torch.from_numpy(tiles4[mine]),
                                       mesh2d._tile_strips(torch.from_numpy(strips_src)),
                                       torch.from_numpy(mine), gx, gy, row_of)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=layout)
        np.testing.assert_array_equal(
            mesh2d._window_mask(torch.from_numpy(mine), gx, ph, pw, w, h).numpy(),
            np.asarray(jm2._window_mask(jnp.asarray(mine), gx, ph, pw, w, h)))
    assert cfg.num_tiles == cfg_j.num_tiles
