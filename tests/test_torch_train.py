"""The port's losses, Adam steps, trainer and checkpoints on the CPU against
the JAX package's (its fast path with the Pallas kernels in interpret mode).

Tolerances, each relative to the compared tensor's largest magnitude:
losses 1e-6 of max(1, |value|) (D-SSIM is (1 - SSIM) / 2, so one float32
ulp of an SSIM near 1 is already 2e-6 of it) and the SSIM map 1e-5 (its
variances are differences of 121-tap sums taken in another order); one
train step 1e-5 and ten steps 1e-3 (Adam divides the
gradient by its own magnitude, so a splat whose gradient is rounding noise
takes a step of the learning rate in a direction the two packages need not
share; the bound is the colour learning rate over the colour range);
continuing a JAX checkpoint for three steps 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.render import camera_args
from openglgaussiansplattingrenderer_tpu.train import losses as jax_losses
from openglgaussiansplattingrenderer_tpu.train import trainer as jax_trainer

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.render import render_stats
from openglgaussiansplattingrenderer_tpu_torch.train import losses, trainer
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(chunk=32, max_per_tile=256, dup_capacity_factor=32.0)
W = H = 64


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", ["l1", "l2", "ssim", "dssim", "gs_loss", "psnr",
                                  "ssim_map"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (40, 52, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(losses, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == tuple(want.shape)
    if name == "ssim_map":
        assert got.shape == (30, 42, 3)
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= (1e-5 if name == "ssim_map" else 1e-6) * scale


def test_loss_gradients_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    want = jax.grad(lambda x: jax_losses.gs_loss(x, jnp.asarray(b), 0.2))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    (got,) = torch.autograd.grad(losses.gs_loss(x, torch.from_numpy(b), 0.2), x)
    assert _rel(got, want) <= 1e-5


def test_losses_basic():
    a = torch.zeros((32, 32, 3))
    b = torch.ones((32, 32, 3)) * 0.5
    assert float(losses.l1(a, a)) == 0.0
    assert float(losses.l2(a, b)) > 0
    assert 0.99 < float(losses.ssim(b, b)) <= 1.0
    assert float(losses.dssim(b, b)) < 1e-5
    assert float(losses.psnr(a, a)) > 100


def test_raw_round_trip_matches_jax():
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(20, seed=1).items()}
    raw_j = jax_trainer.raw_from_params({k: jnp.asarray(v) for k, v in scene.items()})
    params = convert.params_from_numpy(scene, "cpu")
    raw_t = trainer.raw_from_params(params)
    assert set(raw_t) == set(raw_j)
    for k in raw_j:
        assert _rel(raw_t[k], raw_j[k]) <= 1e-6, k
    back = trainer.params_from_raw(raw_t)
    for k in params:
        np.testing.assert_allclose(back[k].numpy(), params[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np_raw = convert.raw_to_numpy(raw_t)
    again = convert.raw_from_numpy(np_raw, "cpu")
    assert all(torch.equal(again[k], raw_t[k]) for k in raw_t)
    with pytest.raises(KeyError):
        convert.raw_from_numpy({"scales": np_raw["log_scales"]}, "cpu")


def _fit_inputs(n=25, seed=6, extent=1.2):
    """(clean scene, noisy-colour scene, camera bundle)."""
    scene = jax_ply.make_synthetic_scene(n, seed=seed, extent=extent)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    scene["opacities"] = np.clip(scene["opacities"], 0.4, 0.9)
    noisy = dict(scene)
    noisy["colors"] = np.clip(
        scene["colors"] + np.random.default_rng(0).normal(0, 60, scene["colors"].shape),
        5, 250).astype(np.float32)
    a = camera_args(Camera(0.0, 0.0, -4.0, width=W, height=H))
    bundle = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
              a["tan_fovy"])
    return scene, noisy, bundle


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Ten steps of the JAX trainer (screen-space grad norms, L1 + D-SSIM,
    position-LR schedule), with the state kept after steps 1, 3, 6 and 10
    and a checkpoint written after step 3."""
    scene, noisy, bundle = _fit_inputs()
    tc = jax_trainer.TrainConfig(lambda_dssim=0.2, lr_means_final=1.6e-6,
                                 lr_means_decay_steps=30)
    cfg = JaxConfig(**CFG)
    from openglgaussiansplattingrenderer_tpu.render import render_arrays as jax_render

    jb = (jnp.asarray(bundle[0]), jnp.asarray(bundle[1])) + bundle[2:]
    target = np.array(jax_render({k: jnp.asarray(v) for k, v in scene.items()},
                                   *jb, W, H, cfg)[0][..., :3])
    raw0 = jax_trainer.raw_from_params({k: jnp.asarray(v) for k, v in noisy.items()})
    step = jax_trainer.make_train_step(cfg, tc, W, H, with_grad_norms=True)
    state = step.init(raw0)
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "step3.npz")
    kept = {}
    for i in range(1, 11):
        state, metrics = step(state, jnp.asarray(target), *jb)
        if i in (1, 3, 6, 10):
            kept[i] = ({k: np.asarray(v) for k, v in state.raw.items()},
                       {k: np.asarray(v) for k, v in metrics.items()})
        if i == 3:
            jax_trainer.save_checkpoint(ckpt, state.raw, step=3,
                                        opt_state=state.opt_state)
    return dict(noisy=noisy, bundle=bundle, target=target, tc=tc, kept=kept,
                ckpt=ckpt, raw0={k: np.asarray(v) for k, v in raw0.items()})


def _port_step(tc, **kw):
    tc_t = trainer.TrainConfig(**dataclasses.asdict(tc))
    return tc_t, trainer.make_train_step(port.RenderConfig(**CFG), tc_t, W, H, **kw)


def _port_bundle(bundle):
    return (torch.from_numpy(bundle[0]), torch.from_numpy(bundle[1])) + bundle[2:]


def test_train_steps_match_jax(jax_run):
    _, step = _port_step(jax_run["tc"], with_grad_norms=True)
    state = step.init(convert.raw_from_numpy(jax_run["raw0"], "cpu"))
    target = torch.from_numpy(jax_run["target"])
    for i in range(1, 11):
        state, metrics = step(state, target, *_port_bundle(jax_run["bundle"]))
        if i in (1, 10):
            raw_j, met_j = jax_run["kept"][i]
            tol = 1e-5 if i == 1 else 1e-3
            for k in raw_j:
                assert _rel(state.raw[k], raw_j[k]) <= tol, (i, k)
            for k in ("loss", "psnr", "densify_grad_norm"):
                assert _rel(metrics[k], met_j[k]) <= tol, (i, k)
    assert state.step == 10 and state.opt_state["count"] == 10
    assert metrics["densify_grad_norm"].shape == (25,)
    # the step really moved the parameters
    assert _rel(state.raw["colors"], jax_run["raw0"]["colors"]) > 1e-3


def test_world_grad_norm_and_custom_loss_match_jax(jax_run):
    # grad_stat="world" with a caller's loss, one step in both packages
    tc = jax_trainer.TrainConfig()
    b = jax_run["bundle"]
    jstep = jax_trainer.make_train_step(
        JaxConfig(**CFG), tc, W, H, with_grad_norms=True, grad_stat="world",
        loss_fn=lambda p, t: jnp.mean((p - t) ** 2))
    js, jm = jstep(jstep.init({k: jnp.asarray(v) for k, v in jax_run["raw0"].items()}),
                   jnp.asarray(jax_run["target"]), jnp.asarray(b[0]),
                   jnp.asarray(b[1]), *b[2:])
    _, step = _port_step(tc, with_grad_norms=True, grad_stat="world",
                         loss_fn=lambda p, t: torch.mean((p - t) ** 2))
    ts, tm = step(step.init(convert.raw_from_numpy(jax_run["raw0"], "cpu")),
                  torch.from_numpy(jax_run["target"]), *_port_bundle(b))
    for k in js.raw:
        assert _rel(ts.raw[k], js.raw[k]) <= 1e-5, k
    for k in ("loss", "psnr", "densify_grad_norm"):
        assert _rel(tm[k], jm[k]) <= 1e-5, k
    with pytest.raises(ValueError):
        trainer.make_train_step(port.RenderConfig(**CFG), trainer.TrainConfig(), W, H,
                                grad_stat="pixel")
    _, plain = _port_step(tc)
    _, m = plain(plain.init(convert.raw_from_numpy(jax_run["raw0"], "cpu")),
                 torch.from_numpy(jax_run["target"]), *_port_bundle(b))
    assert set(m) == {"loss", "psnr", "overflow"} and int(m["overflow"]) == 0


def test_jax_checkpoint_continues_in_the_port(jax_run):
    tc_t, step = _port_step(jax_run["tc"], with_grad_norms=True)
    state = convert.train_state_from_checkpoint(jax_run["ckpt"], tc_t, "cpu")
    assert state.step == 3 and state.opt_state["count"] == 3
    raw3, _ = jax_run["kept"][3]
    for k in raw3:
        np.testing.assert_array_equal(state.raw[k].numpy(), raw3[k])
    target = torch.from_numpy(jax_run["target"])
    for _ in range(3):
        state, _ = step(state, target, *_port_bundle(jax_run["bundle"]))
    raw6, _ = jax_run["kept"][6]
    for k in raw6:
        assert _rel(state.raw[k], raw6[k]) <= 1e-4, k
    # the schedule's leaf is expected exactly when the config has one
    with pytest.raises(ValueError, match="optimizer leaves"):
        convert.train_state_from_checkpoint(jax_run["ckpt"], trainer.TrainConfig(), "cpu")


def test_position_lr_decay_schedule():
    import optax

    kw = dict(lr_means=1e-2, lr_means_final=1e-4, lr_means_decay_steps=50,
              lr_colors=1e-2)
    opt = trainer.make_optimizer(trainer.TrainConfig(**kw))
    jopt = jax_trainer.make_optimizer(jax_trainer.TrainConfig(**kw))
    shapes = {"means": (4, 3), "log_scales": (4, 3), "quats": (4, 4),
              "logit_opacities": (4,), "colors": (4, 3)}
    raw = {k: torch.zeros(s) for k, s in shapes.items()}
    grads = {k: torch.ones(s) for k, s in shapes.items()}
    jraw = {k: jnp.zeros(s) for k, s in shapes.items()}
    jgrads = {k: jnp.ones(s) for k, s in shapes.items()}
    state, jstate = opt.init(raw), jopt.init(jraw)
    steps_means, steps_colors = [], []
    for i in range(60):
        # raw stays zero, so the stepped tensors are the updates themselves
        updates, state = opt.update(grads, state, raw)
        jupdates, jstate = jopt.update(jgrads, jstate, jraw)
        jraw = optax.apply_updates(jraw, jupdates)
        for k in shapes:
            assert _rel(updates[k], jupdates[k]) <= 1e-5, (i, k)
        steps_means.append(float(updates["means"].abs().max()))
        steps_colors.append(float(updates["colors"].abs().max()))
    # step 0 uses lr_means itself: the schedule reads the count before the
    # step's increment
    assert abs(steps_means[0] - 1e-2) < 1e-6
    assert steps_means[1] > 3e-3 and steps_means[-1] < 3e-4
    assert abs(steps_colors[-1] - steps_colors[1]) < 1e-4
    # sh_rest trains at lr_colors / 20
    assert trainer.make_optimizer(trainer.TrainConfig(), ("sh_rest",)).learning_rate(
        "sh_rest", 0) == pytest.approx(2.5e-1 / 20.0)


def test_fit_recovers_color():
    scene, noisy, _ = _fit_inputs()
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    cfg = port.RenderConfig(**CFG)
    clean = convert.params_from_numpy(scene, "cpu")
    target = render_stats(clean, cam, cfg)[0][..., :3]
    start = convert.params_from_numpy(noisy, "cpu")
    psnr0 = float(losses.psnr(render_stats(start, cam, cfg)[0][..., :3], target))
    tc = trainer.TrainConfig(steps=60, lambda_dssim=0.0)
    fitted, hist = trainer.fit_scene(start, [target.numpy()], [cam], cfg, tc,
                                     verbose=False, log_every=20, device="cpu")
    psnr1 = float(losses.psnr(render_stats(fitted, cam, cfg)[0][..., :3], target))
    assert psnr1 > psnr0 + 3.0, f"psnr {psnr0} -> {psnr1}"
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [0, 20, 40, 59]


def test_fit_trains_sh_coefficients():
    cfg = port.RenderConfig(sh_degree=2, **CFG)
    scene = jax_ply.make_synthetic_scene(20, seed=13, extent=1.0)
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    scene["sh_rest"] = np.random.default_rng(3).normal(
        0, 0.35, scene["sh_rest"].shape).astype(np.float32)
    cams = [port.Camera(0.0, 0.0, -4.0, width=W, height=H),
            port.Camera(1.5, 0.0, -3.6, width=W, height=H)]
    cams[1].set_rotation(0.0, -20.0, 0.0)
    full = convert.params_from_numpy(scene, "cpu")
    targets = [render_stats(full, cam, cfg)[0][..., :3].numpy() for cam in cams]
    assert np.abs(targets[0] - targets[1]).max() > 0.01
    start = dict(scene, sh_rest=np.zeros_like(scene["sh_rest"]))
    tc = trainer.TrainConfig(steps=40, lambda_dssim=0.0, lr_colors=2.0)
    fitted, hist = trainer.fit_scene(start, targets, cams, cfg, tc, verbose=False,
                                     log_every=20, device="cpu")
    assert float(fitted["sh_rest"].abs().max()) > 1e-4, "sh_rest got no gradient"
    assert hist[-1]["loss"] < hist[0]["loss"], hist


def test_checkpoint_round_trip(tmp_path):
    scene = {k: v for k, v in jax_ply.make_synthetic_scene(10, seed=2).items()
             if k != "sh_rest"}
    raw = trainer.raw_from_params(convert.params_from_numpy(scene, "cpu"))
    opt = trainer.make_optimizer(trainer.TrainConfig())
    state = opt.init(raw)
    _, state = opt.update({k: torch.ones_like(v) for k, v in raw.items()}, state, raw)
    path = str(tmp_path / "ckpt")                         # .npz is appended
    trainer.save_checkpoint(path, raw, step=7, opt_state=state,
                            alive=np.arange(10) % 2 == 0)
    raw2, step = trainer.load_checkpoint(path)
    assert step == 7 and set(raw2) == set(raw)
    for k in raw:
        np.testing.assert_array_equal(raw2[k], raw[k].numpy())
    _, _, extras = trainer.load_checkpoint_full(path + ".npz")
    np.testing.assert_array_equal(extras["alive"], np.arange(10) % 2 == 0)
    back = trainer.restore_opt_state(opt.init(raw), extras["opt_state"])
    assert back["count"] == 1
    for m in ("mu", "nu"):
        for k in raw:
            assert torch.equal(back[m][k], state[m][k])
    # the JAX package's npz keys for step, raw arrays and extras; the
    # optimizer state under the port's own o_count / o_mu_* / o_nu_* names
    names = set(np.load(path + ".npz").files)
    assert {"step", "x_alive", "o_count", *raw} <= names
    assert names - {"step", "x_alive", "o_count", *raw} == {
        f"o_{m}_{k}" for m in ("mu", "nu") for k in raw}
    # a mismatched parameter set or shape is refused
    only_means = trainer.make_optimizer(trainer.TrainConfig(), ("means",))
    with pytest.raises(ValueError, match="parameter set"):
        trainer.restore_opt_state(only_means.init(raw), extras["opt_state"])
    with pytest.raises(ValueError, match="wrong capacity"):
        trainer.check_resume_shapes(raw, {k: v[:5] for k, v in raw2.items()}, path)
    with pytest.raises(ValueError, match="missing parameters"):
        trainer.check_resume_shapes(raw, {"means": raw2["means"]}, path)
    with pytest.raises(ValueError, match="does not train"):
        trainer.check_resume_shapes(raw, dict(raw2, sh_rest=np.zeros((10, 45))), path)


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    scene, noisy, _ = _fit_inputs(n=20, seed=11)
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    cfg = port.RenderConfig(**CFG)
    target = render_stats(convert.params_from_numpy(scene, "cpu"), cam,
                          cfg)[0][..., :3].numpy()
    tc = trainer.TrainConfig(steps=8, lambda_dssim=0.2, lr_means_final=1e-6)
    ckpt, mid = str(tmp_path / "fit.ckpt.npz"), str(tmp_path / "mid.ckpt.npz")
    ref, _ = trainer.fit_scene(noisy, [target], [cam], cfg, tc, verbose=False,
                               save_every=4, checkpoint_path=ckpt, device="cpu")
    _, step8, extras8 = trainer.load_checkpoint_full(ckpt)
    assert step8 == 8 and extras8["opt_state"]["count"] == 8
    # the "kill": a truncated run leaves the step-4 snapshot behind
    tc4 = dataclasses.replace(tc, steps=4, lr_means_decay_steps=8)
    trainer.fit_scene(noisy, [target], [cam], cfg, tc4, verbose=False,
                      save_every=4, checkpoint_path=mid, device="cpu")
    assert trainer.load_checkpoint(mid)[1] == 4
    resumed, hist = trainer.fit_scene(noisy, [target], [cam], cfg, tc, verbose=False,
                                      resume=mid, device="cpu")
    assert hist[0]["step"] == 7
    for k in ref:
        assert torch.equal(ref[k], resumed[k]), f"resume diverged on {k}"


def test_fit_scene_defaults_to_the_card():
    # no silent CPU route: without a CUDA device the default raises
    scene, noisy, _ = _fit_inputs()
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        trainer.fit_scene(noisy, [np.zeros((H, W, 3), np.float32)], [cam],
                          port.RenderConfig(**CFG), trainer.TrainConfig(steps=1),
                          verbose=False)
