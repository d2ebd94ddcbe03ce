"""The port's 2-D (view x splat) mesh training (``parallel/mesh2d.py``) on
meshes of repeated CPU devices, against the port's own single-device path.

Tolerances: the halo-padded SSIM against the whole image's, rtol 1e-5 (the
JAX test's); the 2-D update against the sequential mean of single-device
gs-loss gradients, rtol 2e-4 / atol 1e-6, and its loss within 1e-5 (the
JAX test's); the densify statistic within 1e-6 of the sum of per-view
statistics, seen counts exactly; a 2x2 + ADC run against the 1x1 run, rtol
2e-4 / atol 1e-6 and the same alive mask; a resumed run bit for bit.
"""

import numpy as np
import pytest
import torch

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.parallel import mesh2d
from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import pad_scene_for_mesh
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
CFG = port.RenderConfig(grid_x=2, grid_y=2, chunk=32, dup_capacity_factor=8.0,
                        max_per_tile=256)
TC = TrainConfig()
ADC_TC = dict(steps=8, lambda_dssim=0.0, lr_means=3e-3)
ADC_DC = dict(capacity=24, grad_threshold=1e-6, scene_extent=1.2, start_step=0,
              interval=3, stop_step=8)


def _mesh(dv, ds):
    return mesh2d.make_mesh2d(dv, ds, devices=["cpu"] * (dv * ds))


def _setup(n_views, w=W, h=H, seed=7, n=48):
    scene = {k: v for k, v in ply_io.make_synthetic_scene(n, seed=seed, extent=1.5).items()
             if k != "sh_rest"}
    raw = raw_from_params(pad_scene_for_mesh(params_from_numpy(scene, "cpu"), 4))
    cams = [port.Camera(0.4 * i - 0.6, 0.2, -4.0 - 0.3 * i, width=w, height=h)
            for i in range(n_views)]
    rng = np.random.default_rng(seed + 1)
    targets = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(n_views)]
    return raw, targets, camera_bundles(cams, "cpu")


def _stack_args(targets, bundles, cfg=CFG, w=W, h=H):
    tgt = torch.stack([torch.from_numpy(mesh2d.tile_target(t, w, h, cfg)[0])
                       for t in targets])
    return (tgt, torch.stack([b[0] for b in bundles]), torch.stack([b[1] for b in bundles]),
            *(torch.tensor([float(b[j]) for b in bundles]) for j in (2, 3, 4, 5)))


def _reference(raw, targets, bundles, cfg=CFG, w=W, h=H, lambda_dssim=TC.lambda_dssim):
    """B sequential single-device gs-loss evaluations: (mean loss, mean
    gradient, per-view screen statistics)."""
    grads, loss_sum, norms = None, 0.0, []
    for t, b in zip(targets, bundles):
        leaves = {k: v.clone().requires_grad_(True) for k, v in raw.items()}
        shift = torch.zeros((raw["means"].shape[0], 2), requires_grad=True)
        params = dict(params_from_raw(leaves), shift2d=shift)
        img, _ = render_arrays(params, *b, w, h, cfg)
        loss = losses.gs_loss(img[..., :3], torch.from_numpy(t), lambda_dssim)
        g = torch.autograd.grad(loss, list(leaves.values()) + [shift])
        gd = dict(zip(leaves, g[:-1]))
        grads = gd if grads is None else {k: grads[k] + gd[k] for k in grads}
        loss_sum += float(loss.detach())
        norms.append(torch.linalg.vector_norm(g[-1] * torch.tensor([w / 2.0, h / 2.0]), dim=-1))
    return loss_sum / len(targets), {k: v / len(targets) for k, v in grads.items()}, norms


def _tiles_of(x, gx, gy):
    h, w = x.shape[:2]
    ph, pw = h // gy, w // gx
    return torch.from_numpy(x.reshape(gy, ph, gx, pw, 3).transpose(0, 2, 1, 3, 4)
                            .reshape(gy * gx, ph, pw, 3))


@pytest.mark.parametrize("row_layout", ["global", "owner_major"])
def test_halo_padded_ssim_equals_whole_image_ssim(row_layout):
    """Border-strip halos + padded-tile windows + the centre-pixel mask give
    the whole image's SSIM: the masked window sum over (H-10)(W-10)C is the
    single-device valid-window mean, with the strips in global tile order
    and in the owner-major order of a 4-owner all-gather."""
    rng = np.random.default_rng(5)
    h = w = 32
    gx = gy = 4
    ph, pw = h // gy, w // gx
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    ref = float(losses.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    ta, tb = _tiles_of(a, gx, gy), _tiles_of(b, gx, gy)
    t = gx * gy
    got = windows = 0.0
    owners = 1 if row_layout == "global" else 4
    tpd = t // owners
    for d in range(owners):
        mine = d + owners * torch.arange(tpd, dtype=torch.int32)
        pads = []
        for x in (ta, tb):
            if row_layout == "global":
                strips, row_of = mesh2d._tile_strips(x), (lambda t2: t2)
            else:       # owner-major: owner e's tiles e, e + 4, ... in a block
                order = torch.cat([e + owners * torch.arange(tpd) for e in range(owners)])
                strips = mesh2d._tile_strips(x[order])
                row_of = (lambda t2: (t2 % owners) * tpd + t2 // owners)
            pads.append(mesh2d._padded_tiles(x[mine.long()], strips, mine, gx, gy, row_of))
        m = mesh2d._window_mask(mine, gx, ph, pw, w, h)
        got += float(torch.sum(losses.ssim_map(*pads) * m[..., None]))
        windows += float(m.sum())
    assert windows == (h - 10) * (w - 10)
    np.testing.assert_allclose(got / ((h - 10) * (w - 10) * 3), ref, rtol=1e-5)


def test_tile_target_roundtrip():
    """tile_target's layout inverts assemble_image's exactly."""
    target = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    tiles, mask = mesh2d.tile_target(target, W, H, CFG)
    gx, gy = CFG.grid_x, CFG.grid_y
    ph, pw = H // gy, W // gx
    back = tiles.reshape(gy, gx, ph, pw, 3).transpose(0, 2, 1, 3, 4).reshape(H, W, 3)
    np.testing.assert_array_equal(back, target)
    np.testing.assert_array_equal(mask, np.ones((gy * gx, ph * pw)))


@pytest.mark.parametrize("dv,ds", [(1, 2), (2, 1), (2, 2)])
def test_2d_step_matches_sequential_mean(dv, ds):
    batch = 2
    raw, targets, bundles = _setup(batch)
    keys = tuple(sorted(raw))
    mesh = _mesh(dv, ds)
    step = mesh2d.make_2d_train_step(CFG, TC, W, H, mesh, batch=batch, param_keys=keys,
                                     with_grad_norms=True)
    rs = mesh2d.shard_raw_2d(raw, mesh)
    new_raw, opt, loss, psnr, over, gnorm, seen = step(rs, step.init(rs),
                                                       *_stack_args(targets, bundles))
    assert int(over) == 0 and len(new_raw) == ds and all(o["count"] == 1 for o in opt)
    loss_ref, grads, norms = _reference(raw, targets, bundles)
    assert abs(float(loss) - loss_ref) < 1e-5
    psnr_ref = np.mean([float(losses.psnr(render_arrays(params_from_raw(raw), *b, W, H, CFG)[0]
                                          [..., :3], torch.from_numpy(t)))
                        for t, b in zip(targets, bundles)])
    assert abs(float(psnr) - psnr_ref) < 1e-4
    optimizer = make_optimizer(TC, keys=keys)
    stepped, _ = optimizer.update(grads, optimizer.init(raw), raw)
    got = mesh2d.gather_raw_2d(new_raw, "cpu")
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), stepped[k].numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=f"2d update mismatch for {k}")
    # the densify statistic: each view's own norm, summed over the batch
    assert float(gnorm.max()) > 0.0
    np.testing.assert_allclose(gnorm.numpy(), sum(norms).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(seen.numpy(), sum((v > 0).float() for v in norms).numpy())


def test_2d_gs_loss_nondivisible_resolution():
    """34x34 on a 2x2 grid: tiles pad to 18 px, and the window mask keeps
    exactly the (H-10)(W-10) valid windows of the true image (edge halo
    strips hold pad pixels no valid window reaches)."""
    w = h = 34
    raw, targets, bundles = _setup(2, w, h, seed=3)
    mesh = _mesh(2, 2)
    step = mesh2d.make_2d_train_step(CFG, TC, w, h, mesh, batch=2,
                                     param_keys=tuple(sorted(raw)))
    rs = mesh2d.shard_raw_2d(raw, mesh)
    _, _, loss, _, over = step(rs, step.init(rs), *_stack_args(targets, bundles, w=w, h=h))
    assert int(over) == 0
    loss_ref, _, _ = _reference(raw, targets, bundles, w=w, h=h)
    assert abs(float(loss) - loss_ref) < 1e-5, (float(loss), loss_ref)


def test_2d_loss_decreases_over_steps():
    """A few 2-D steps towards the start's own render, from perturbed
    colours, reduce the loss."""
    raw, _, bundles = _setup(2, seed=11)
    targets = [render_arrays(params_from_raw(raw), *b, W, H, CFG)[0][..., :3].numpy()
               for b in bundles]
    raw = dict(raw, colors=raw["colors"] + 60.0 * torch.from_numpy(
        np.random.default_rng(0).standard_normal(raw["colors"].shape).astype(np.float32)))
    mesh = _mesh(2, 2)
    step = mesh2d.make_2d_train_step(CFG, TC, W, H, mesh, batch=2,
                                     param_keys=tuple(sorted(raw)))
    rs = mesh2d.shard_raw_2d(raw, mesh)
    opt = step.init(rs)
    args = _stack_args(targets, bundles)
    seen = []
    for _ in range(30):
        rs, opt, loss, _, _ = step(rs, opt, *args)
        seen.append(float(loss))
    assert seen[-1] < seen[0] * 0.7, seen


def _adc_setup():
    scene = {k: v for k, v in ply_io.make_synthetic_scene(20, seed=11, extent=1.2).items()
             if k != "sh_rest"}
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    cams = [port.Camera(0.4 * i - 0.2, 0.2, -4.0, width=W, height=H) for i in range(2)]
    full = params_from_numpy(scene, "cpu")
    targets = [render_arrays(full, *b, W, H, CFG)[0][..., :3].numpy()
               for b in camera_bundles(cams, "cpu")]
    return {k: v[:6] for k, v in scene.items()}, targets, cams


def _fit(dv, ds, **kw):
    start, targets, cams = _adc_setup()
    tc = TrainConfig(**dict(ADC_TC, **kw.pop("tc", {})))
    return mesh2d.fit_scene_2d(start, targets, cams, CFG, tc, mesh=_mesh(dv, ds), batch=2,
                               dc=dn.DensifyConfig(**ADC_DC), seed=5, verbose=False, **kw)


def test_2d_adc_parity_with_1x1_mesh():
    """2-D + adaptive density control on (2, 2) equals the same run on
    (1, 1): densify runs once on the gathered state with one generator,
    and only two-term view sums separate the runs."""
    p22, alive22, hist22 = _fit(2, 2)
    p11, alive11, hist11 = _fit(1, 1)
    assert torch.equal(alive22, alive11)
    assert int(alive22.sum()) > 6, "densification never allocated"
    for k in p11:
        np.testing.assert_allclose(p22[k].numpy(), p11[k].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=f"2d+ADC diverged on {k}")
    assert [h["step"] for h in hist22] == [0, 7]
    assert hist22[-1]["alive"] == int(alive22.sum()) and hist22[-1]["overflow"] == 0


def test_2d_adc_kill_and_resume_matches(tmp_path):
    """A 2x2 + ADC run checkpointed at step 4 (the gathered state in one
    npz) and resumed (sharded again) replays the uninterrupted 8-step run
    exactly, densify state and generator included."""
    ref, alive_ref, hist = _fit(2, 2)
    mid = str(tmp_path / "m2.ckpt.npz")
    _fit(2, 2, tc=dict(steps=4), save_every=4, checkpoint_path=mid)
    res, alive_res, hist_res = _fit(2, 2, resume=mid)
    assert torch.equal(alive_ref, alive_res)
    for k in ref:
        assert torch.equal(ref[k], res[k]), f"mesh2d resume diverged on {k}"
    assert hist_res[-1] == dict(hist[-1], wall_s=hist_res[-1]["wall_s"])


@pytest.mark.parametrize("case", ["batch", "tiles", "small_tiles", "small_image",
                                  "shards", "no_cards"])
def test_2d_refuses_what_it_cannot_run(case):
    if case == "no_cards":
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA devices asked for"):
            mesh2d.make_mesh2d(2, 2)
        return
    w, h, cfg, mesh, kw = W, H, CFG, _mesh(2, 2), {}
    if case == "batch":
        kw, match = dict(batch=3), "not a multiple of view rows"
    elif case == "tiles":
        cfg, match = port.RenderConfig(grid_x=3, grid_y=1), "tiles not divisible by 2"
    elif case == "small_tiles":
        cfg, match = port.RenderConfig(grid_x=8, grid_y=8), "needs tiles >= 5 px"
    elif case == "small_image":
        w = h = 10
        cfg, match = port.RenderConfig(grid_x=2, grid_y=1), "needs images > 10 px"
    else:
        with pytest.raises(ValueError, match="not divisible by 2 splat shards"):
            mesh2d.shard_raw_2d({"means": torch.zeros(3, 3)}, mesh)
        return
    with pytest.raises(ValueError, match=match):
        mesh2d.make_2d_train_step(cfg, TC, w, h, mesh, **kw)
