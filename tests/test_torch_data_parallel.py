"""The port's view-parallel training (``parallel/data_parallel.py``) on CPU
meshes, against B sequential single-device gradient evaluations averaged
into one update, and against the JAX package's ``make_dp_train_step`` on
conftest's 8 virtual CPU devices (Pallas in interpret mode).

Tolerances: the dp update against the sequential mean and against JAX's
dp update, rtol 2e-4 / atol 1e-6, the JAX test's own; losses within 1e-4
(the frame contract) and PSNRs within 1e-2 dB (what 1e-4 a pixel can
move a PSNR near 5 dB by); the summed screen-gradient statistic within 5e-3 of
its largest value (the gradient contract) and the seen counts exactly (on
the ADC run's L1 loss, where a start that equals its target to rounding
makes the pixel gradients' signs arbitrary, only the seen counts and which
splats have a statistic); a 2-shard dp + ADC run against the 1-shard run,
rtol 2e-4 / atol 1e-6 and the same alive mask; a resumed run equal to the
uninterrupted one, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.parallel import data_parallel as jdp
from openglgaussiansplattingrenderer_tpu.train import trainer as jtrainer

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.parallel import data_parallel as dp
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
from openglgaussiansplattingrenderer_tpu_torch.train import losses
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
    TrainConfig,
    camera_bundles,
    make_optimizer,
    params_from_raw,
    raw_from_params,
)
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = H = 32
OPTS = dict(grid_x=2, grid_y=2, chunk=32, dup_capacity_factor=8.0, max_per_tile=256)
CFG = port.RenderConfig(**OPTS)
TC = TrainConfig(lambda_dssim=0.2)
ADC_TC = dict(steps=8, lambda_dssim=0.0, lr_means=3e-3)
ADC_DC = dict(capacity=24, grad_threshold=1e-6, scene_extent=1.2, start_step=0,
              interval=3, stop_step=8)


def _mesh(n):
    return dp.make_mesh(devices=["cpu"] * n)


def _cams(n_views, camera=port.Camera):
    return [camera(0.4 * i - 0.6, 0.2, -4.0 - 0.3 * i, width=W, height=H)
            for i in range(n_views)]


def _setup(n_views, n=48, seed=5):
    scene = jax_ply.make_synthetic_scene(n, seed=seed, extent=1.5)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    rng = np.random.default_rng(seed + 1)
    targets = [rng.uniform(0, 1, (H, W, 3)).astype(np.float32) for _ in range(n_views)]
    return scene, targets


@functools.lru_cache(maxsize=None)
def _jax_step(ndev, batch, with_grad_norms=False):
    """JAX's dp step on ``_setup(batch)``: (raw after, loss, grads-free
    outputs...) as host arrays."""
    scene, targets = _setup(batch)
    raw = jtrainer.raw_from_params({k: jnp.asarray(v) for k, v in scene.items()})
    keys = tuple(sorted(raw))
    step = jdp.make_dp_train_step(JaxConfig(**OPTS), jtrainer.TrainConfig(lambda_dssim=0.2),
                                  W, H, jdp.make_mesh(ndev), batch=batch,
                                  param_keys=keys, with_grad_norms=with_grad_norms)
    args = jdp.stack_view_batch(targets, jtrainer.camera_bundles(_cams(batch, JaxCamera)))
    out = step(raw, step.init(raw), *args)
    return ({k: np.asarray(v) for k, v in out[0].items()},
            *(np.asarray(v) for v in out[2:]))


def _port_step(ndev, batch, with_grad_norms=False):
    scene, targets = _setup(batch)
    raw = raw_from_params(params_from_numpy(scene, "cpu"))
    keys = tuple(sorted(raw))
    mesh = _mesh(ndev)
    step = dp.make_dp_train_step(CFG, TC, W, H, mesh, batch=batch, param_keys=keys,
                                 with_grad_norms=with_grad_norms)
    raw_r = dp.replicate_tree(raw, mesh)
    args = dp.stack_view_batch(targets, camera_bundles(_cams(batch), "cpu"), "cpu")
    return raw, step(raw_r, step.init(raw_r), *args)


def _sequential(raw, batch):
    """Per-view gradients of the port's single-device loss: (loss mean,
    mean gradient, per-view screen statistics)."""
    _, targets = _setup(batch)
    grads, loss_sum, norms = None, 0.0, []
    for t, b in zip(targets, camera_bundles(_cams(batch), "cpu")):
        leaves = {k: v.clone().requires_grad_(True) for k, v in raw.items()}
        shift = torch.zeros((raw["means"].shape[0], 2), requires_grad=True)
        params = params_from_raw(leaves)
        params["shift2d"] = shift
        img, _ = render_arrays(params, *b, W, H, CFG)
        loss = losses.gs_loss(img[..., :3], torch.from_numpy(t), TC.lambda_dssim)
        g = torch.autograd.grad(loss, list(leaves.values()) + [shift])
        gd = dict(zip(leaves, g[:-1]))
        grads = gd if grads is None else {k: grads[k] + gd[k] for k in grads}
        loss_sum += float(loss.detach())
        norms.append(torch.linalg.vector_norm(g[-1] * torch.tensor([W / 2.0, H / 2.0]),
                                              dim=-1))
    return loss_sum / batch, {k: v / batch for k, v in grads.items()}, norms


@pytest.mark.parametrize("ndev,batch", [(4, 4), (4, 8)])
def test_dp_step_matches_sequential_mean_and_jax(ndev, batch):
    raw, (raw_r, opt_r, loss, psnr) = _port_step(ndev, batch)
    assert len(raw_r) == ndev and all(o["count"] == 1 for o in opt_r)
    for r in raw_r[1:]:
        for k in r:
            assert torch.equal(r[k], raw_r[0][k]), "the replicas differ"
    loss_ref, grads, _ = _sequential(raw, batch)
    optimizer = make_optimizer(TC, keys=tuple(sorted(raw)))
    stepped, _ = optimizer.update(grads, optimizer.init(raw), raw)
    assert abs(float(loss) - loss_ref) < 1e-5
    want_raw, want_loss, want_psnr = _jax_step(ndev, batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    assert abs(float(psnr) - float(want_psnr)) <= 1e-2
    for k in raw:
        got = raw_r[0][k].numpy()
        np.testing.assert_allclose(got, stepped[k].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=f"dp update mismatch for {k}")
        np.testing.assert_allclose(got, want_raw[k], rtol=2e-4, atol=1e-6,
                                   err_msg=f"dp update vs JAX for {k}")


def test_dp_grad_norms_sum_over_views_and_match_jax():
    batch = 4
    raw, (_, _, _, _, gnorm, seen) = _port_step(4, batch, with_grad_norms=True)
    n = raw["means"].shape[0]
    assert gnorm.shape == seen.shape == (n,)
    assert bool(torch.isfinite(gnorm).all()) and float(gnorm.max()) > 0.0
    assert float(seen.max()) <= batch
    assert torch.equal(seen > 0, gnorm > 0)
    _, _, norms = _sequential(raw, batch)
    np.testing.assert_allclose(gnorm.numpy(), sum(norms).numpy(), rtol=2e-4, atol=1e-7)
    np.testing.assert_array_equal(seen.numpy(), sum((v > 0).float() for v in norms).numpy())
    _, _, _, want_gnorm, want_seen = _jax_step(4, batch, with_grad_norms=True)
    assert np.abs(gnorm.numpy() - want_gnorm).max() <= 5e-3 * want_gnorm.max()
    np.testing.assert_array_equal(seen.numpy(), want_seen)


def _adc_setup():
    scene = jax_ply.make_synthetic_scene(20, seed=11, extent=1.2)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    cams = [port.Camera(0.4 * i - 0.2, 0.2, -4.0, width=W, height=H) for i in range(2)]
    full = params_from_numpy(scene, "cpu")
    targets = []
    for b in camera_bundles(cams, "cpu"):
        img, _ = render_arrays(full, *b, W, H, CFG)
        targets.append(img[..., :3].numpy())
    start = {k: v[:6] for k, v in scene.items()}
    return start, targets, cams


@functools.lru_cache(maxsize=None)
def _jax_adc_first_step():
    """JAX's first dp step (with grad norms) of the ADC runs: (loss, grad
    norm sum, seen)."""
    start, targets, _ = _adc_setup()
    raw = jtrainer.raw_from_params({k: jnp.asarray(v) for k, v in start.items()})
    from openglgaussiansplattingrenderer_tpu.train import densify as jdn

    raw, _ = jdn.pad_to_capacity(raw, ADC_DC["capacity"])
    cams = [JaxCamera(0.4 * i - 0.2, 0.2, -4.0, width=W, height=H) for i in range(2)]
    step = jdp.make_dp_train_step(JaxConfig(**OPTS), jtrainer.TrainConfig(**ADC_TC),
                                  W, H, jdp.make_mesh(2), batch=2,
                                  param_keys=tuple(sorted(raw)), with_grad_norms=True)
    out = step(raw, step.init(raw), *jdp.stack_view_batch(
        targets, jtrainer.camera_bundles(cams)))
    return float(out[2]), np.asarray(out[4]), np.asarray(out[5])


def _fit(ndev, **kw):
    start, targets, cams = _adc_setup()
    return dp.fit_scene_dp(start, targets, cams, CFG, TrainConfig(**dict(ADC_TC, **kw.pop("tc", {}))),
                           mesh=_mesh(ndev), batch=2, dc=dn.DensifyConfig(**ADC_DC),
                           seed=5, verbose=False, **kw)


def test_dp_adc_parity_with_single_device_and_jax():
    """A 2-shard dp + ADC run equals the 1-shard run (batch 2 keeps every
    cross-view reduction a two-term sum), and its first step is JAX's."""
    p2, alive2, hist2 = _fit(2)
    p1, alive1, hist1 = _fit(1)
    assert torch.equal(alive2, alive1)
    assert int(alive2.sum()) > 6, "densification never allocated"
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=f"dp+ADC diverged on {k}")
    assert [h["step"] for h in hist2] == [0, 7]

    # the first step against JAX's, on the same padded start
    start, targets, cams = _adc_setup()
    raw, _ = dn.pad_to_capacity(raw_from_params(params_from_numpy(start, "cpu")),
                                ADC_DC["capacity"])
    mesh = _mesh(2)
    step = dp.make_dp_train_step(CFG, TrainConfig(**ADC_TC), W, H, mesh, batch=2,
                                 param_keys=tuple(sorted(raw)), with_grad_norms=True)
    raw_r = dp.replicate_tree(raw, mesh)
    out = step(raw_r, step.init(raw_r), *dp.stack_view_batch(
        targets, camera_bundles(cams, "cpu"), "cpu"))
    want_loss, want_gnorm, want_seen = _jax_adc_first_step()
    assert abs(float(out[2]) - want_loss) <= 1e-4
    assert abs(hist2[0]["loss"] - want_loss) <= 1e-4
    # the loss is L1 and the start's frame equals the target to rounding on
    # the pixels its splats cover, so there the packages' pixel gradients
    # take either sign: the statistic's values are not held to JAX's here
    # (they are in the grad-norm test, on random targets), which splats it
    # reaches are
    assert want_gnorm.max() > 0
    np.testing.assert_array_equal(out[5].numpy(), want_seen)
    np.testing.assert_array_equal(out[4].numpy() > 0, want_gnorm > 0)


def test_dp_adc_kill_and_resume_matches(tmp_path):
    """A dp + ADC run checkpointed at step 4 and resumed replays the
    uninterrupted 8-step run exactly (replicated state, densify state and
    the generator's state round-trip through the npz)."""
    ref, alive_ref, hist = _fit(2)
    mid = str(tmp_path / "dp.ckpt.npz")
    _fit(2, tc=dict(steps=4), save_every=4, checkpoint_path=mid)
    res, alive_res, hist_res = _fit(2, resume=mid)
    assert torch.equal(alive_ref, alive_res)
    for k in ref:
        assert torch.equal(ref[k], res[k]), f"dp resume diverged on {k}"
    assert hist_res[-1] == dict(hist[-1], wall_s=hist_res[-1]["wall_s"])
    assert abs(hist[0]["loss"] - _jax_adc_first_step()[0]) <= 1e-4


def test_dp_rejects_a_batch_the_mesh_does_not_divide():
    with pytest.raises(ValueError, match="multiple of mesh size"):
        dp.make_dp_train_step(CFG, TC, W, H, _mesh(4), batch=6)
