"""The port's adaptive density control (``train/densify.py``) on the CPU,
held against the JAX package's and mirroring every test of
``tests/test_densify.py``.

Tolerances: ``pad_to_capacity``, the alive and changed masks, the stats,
the gradient statistics and the reset rows exact; raw parameters after
``densify_and_prune`` with the JAX package's draws injected within 1e-6 of
each tensor's largest magnitude (the split offsets go through ``einsum``
and ``quat_to_rotmat``, rounded in another order); the loss history of a
split-free adaptive fit within 1e-4 relative over six steps, and a JAX
checkpoint continued in the port for three steps within 1e-4 (as
``test_torch_train.py`` continues one); the screen statistic within 1e-4
of autodiff through the oracle, as ``test_densify_trigger.py``.
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
from openglgaussiansplattingrenderer_tpu.render import render_stats as jax_render_stats
from openglgaussiansplattingrenderer_tpu.train import densify as jdn
from openglgaussiansplattingrenderer_tpu.train import trainer as jax_trainer

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.ops import binning, compositing, projection
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import build_covariance
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_stats
from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
from openglgaussiansplattingrenderer_tpu_torch.train import losses, trainer
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = dict(use_pallas=False, chunk=32, max_per_tile=256, dup_capacity_factor=32.0)
CFG = port.RenderConfig(**OPTS)
# the kernels' path, on the CPU through their plain versions: the port's
# main path, and four times faster here than the oracle's dense compositor
KCFG = dataclasses.replace(CFG, use_pallas=True)
W = H = 64


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _raw_scene(n, seed=3, **kw):
    """The same raw dict for both packages: (jax raw, port raw, activated)."""
    scene = jax_ply.make_synthetic_scene(n, seed=seed, **kw)
    params = {k: jnp.asarray(v) for k, v in scene.items() if k != "sh_rest"}
    jraw = jax_trainer.raw_from_params(params)
    traw = convert.raw_from_numpy({k: np.asarray(v) for k, v in jraw.items()}, "cpu")
    return jraw, traw, params


def _dc(**kw):
    base = dict(capacity=32, grad_threshold=0.5, percent_dense=0.01,
                scene_extent=1.0, min_opacity=0.005)
    base.update(kw)
    return base


def _jax_draws(key, cap):
    """The two (cap, 3) draws of JAX's densify_and_prune (densify.py:204,
    :225-226), as the port's (2, cap, 3) ``normals``."""
    n1 = jax.random.normal(key, (cap, 3), jnp.float32)
    n2 = jax.random.normal(jax.random.fold_in(key, 1), (cap, 3), jnp.float32)
    return torch.from_numpy(np.stack([np.asarray(n1), np.asarray(n2)]))


def test_pad_to_capacity_matches_jax():
    jraw, traw, _ = _raw_scene(12)
    jraw["sh_rest"] = jnp.ones((12, 45), jnp.float32)
    traw["sh_rest"] = torch.ones((12, 45))
    jp, ja = jdn.pad_to_capacity(jraw, 32)
    tp, ta = dn.pad_to_capacity(traw, 32)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    with pytest.raises(ValueError, match="exceed"):
        dn.pad_to_capacity(traw, 8)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pad_renders_identically(use_pallas):
    """Dead rows add nothing to the image on both paths. On the kernels'
    path (their plain versions here) they are never allocated under
    tight_rect, and die in the expansion's reachability cull without it."""
    cfg = dataclasses.replace(CFG, use_pallas=use_pallas)
    _, raw, _ = _raw_scene(12)
    params = trainer.params_from_raw(raw)
    padded, alive = dn.pad_to_capacity(raw, 32)
    assert int(alive.sum()) == 12
    cam = port.Camera(0.0, 0.0, -4.0, width=64, height=64)
    img0, stats0 = render_stats(params, cam, cfg)
    img1, stats1 = render_stats(trainer.params_from_raw(padded), cam, cfg)
    np.testing.assert_allclose(img1.numpy(), img0.numpy(), atol=1e-5)
    if use_pallas:
        live0 = int(stats0["num_records"]) - int(stats0["culled_unreachable"])
        live1 = int(stats1["num_records"]) - int(stats1["culled_unreachable"])
        assert live1 == live0, (stats0, stats1)
        loose = dataclasses.replace(cfg, tight_rect=False)
        img2, stats2 = render_stats(trainer.params_from_raw(padded), cam, loose)
        np.testing.assert_allclose(img2.numpy(), img0.numpy(), atol=1e-5)
        _, stats0l = render_stats(params, cam, loose)
        extra = int(stats2["culled_unreachable"]) - int(stats0l["culled_unreachable"])
        assert extra >= 20, (stats0l, stats2)


def _case(name):
    """(n, scene kwargs, capacity, accum, seen, dc kwargs, key seed, edit)
    of each test_densify.py case, and a mixed one with every branch."""
    cap = 16
    accum = np.zeros(cap, np.float32)
    seen = np.ones(cap, np.float32)
    dc, kw, edit = {}, {}, None
    if name == "prune":
        n = 8
        seen[:] = 0
        edit = 3
    elif name == "clone":
        n, kw = 8, dict(log_scale_range=(-6.0, -5.0))
        accum[[2, 5]] = 10.0
        dc = dict(scene_extent=100.0)
    elif name == "split":
        n, kw = 8, dict(log_scale_range=(-1.0, -0.5))
        accum[4] = 10.0
    elif name == "capacity_limit":
        n, kw = 14, dict(log_scale_range=(-6.0, -5.0))
        accum[[1, 3, 6, 9]] = [5.0, 20.0, 10.0, 1.0]
        dc = dict(scene_extent=100.0)
    else:                                   # mixed: every branch at once
        cap, n, kw = 32, 24, dict(log_scale_range=(-4.5, -2.5))
        rng = np.random.default_rng(5)
        accum = (rng.uniform(0, 2, cap) * (rng.uniform(0, 1, cap) > 0.3)).astype(np.float32)
        seen = rng.integers(0, 3, cap).astype(np.float32)
        dc = dict(grad_threshold=0.4, scene_extent=5.0)
        edit = 7
    return n, kw, cap, accum, seen, _dc(capacity=cap, **dc), edit


def _run_both(name):
    n, kw, cap, accum, seen, dck, edit = _case(name)
    jraw, traw, _ = _raw_scene(n, **kw)
    if edit is not None:       # one transparent splat to prune
        jraw["logit_opacities"] = jraw["logit_opacities"].at[edit].set(
            jax_trainer.inverse_sigmoid(jnp.float32(0.001)))
        traw["logit_opacities"][edit] = float(jraw["logit_opacities"][edit])
    jp, ja = jdn.pad_to_capacity(jraw, cap)
    tp, ta = dn.pad_to_capacity(traw, cap)
    key = jax.random.PRNGKey(1 if name == "split" else 0)
    jout = jdn.densify_and_prune(jp, ja, jnp.asarray(accum), jnp.asarray(seen), key,
                                 jdn.DensifyConfig(**dck))
    tout = dn.densify_and_prune(tp, ta, torch.from_numpy(accum), torch.from_numpy(seen),
                                dn.DensifyConfig(**dck), normals=_jax_draws(key, cap))
    return (tp, ta), jout, tout, dn.DensifyConfig(**dck)


CASES = ["prune", "clone", "split", "capacity_limit", "mixed"]


@pytest.mark.parametrize("name", CASES)
def test_densify_and_prune_matches_jax(name):
    _, (jraw, jalive, jchanged, jstats), (raw, alive, changed, stats), _ = _run_both(name)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    np.testing.assert_array_equal(changed.numpy(), np.asarray(jchanged))
    assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in jstats.items()}
    for k in jraw:
        assert _rel(raw[k], jraw[k]) <= 1e-6, k
    if name == "mixed":
        assert all(int(stats[k]) > 0 for k in ("pruned", "cloned", "split")), stats


def test_prune_kills_transparent():
    _, _, (out, alive2, changed, stats), _ = _run_both("prune")
    assert int(stats["pruned"]) == 1
    assert not bool(alive2[3]) and bool(changed[3])
    assert float(out["logit_opacities"][3]) == dn.DEAD_LOGIT
    assert float(out["log_scales"][3].max()) == dn.DEAD_LOG_SCALE
    assert int(stats["alive"]) == 7


def test_clone_copies_into_free_slots():
    (padded, alive), _, (out, alive2, changed, stats), _ = _run_both("clone")
    assert int(stats["cloned"]) == 2 and int(stats["split"]) == 0
    assert int(alive2.sum()) == 10
    new_rows = np.where(alive2.numpy() & ~alive.numpy())[0]
    assert list(new_rows) == [8, 9]
    src = {2, 5}
    for r in new_rows:
        matched = [s for s in src if torch.equal(out["means"][r], padded["means"][s])]
        assert matched, f"clone row {r} matches no candidate"
        src.remove(matched[0])
        assert bool(changed[r])


def test_split_shrinks_and_samples():
    (padded, alive), _, (out, alive2, changed, stats), dc = _run_both("split")
    assert int(stats["split"]) == 1 and int(stats["cloned"]) == 0
    new_row = int(np.where(alive2.numpy() & ~alive.numpy())[0][0])
    shrink = np.log(dc.split_factor)
    for r in (new_row, 4):
        np.testing.assert_allclose(out["log_scales"][r].numpy(),
                                   padded["log_scales"][4].numpy() - shrink, rtol=1e-6)
    assert bool(changed[4]) and bool(changed[new_row])
    sig = float(torch.exp(padded["log_scales"][4]).max())
    for r in (4, new_row):
        assert float(torch.linalg.vector_norm(out["means"][r] - padded["means"][4])) < 5 * sig
    assert not torch.allclose(out["means"][4], out["means"][new_row])


def test_capacity_limit_prefers_strongest():
    (padded, alive), _, (out, alive2, changed, stats), _ = _run_both("capacity_limit")
    assert int(alive2.sum()) == 16 and int(stats["cloned"]) == 2
    new_rows = np.where(alive2.numpy() & ~alive.numpy())[0]
    got = {tuple(np.round(out["means"][r].numpy(), 5)) for r in new_rows}
    want = {tuple(np.round(padded["means"][s].numpy(), 5)) for s in (3, 6)}
    assert got == want


def test_draws_come_from_the_generator():
    n, kw, cap, accum, seen, dck, _ = _case("split")
    _, raw, _ = _raw_scene(n, **kw)
    padded, alive = dn.pad_to_capacity(raw, cap)
    args = (padded, alive, torch.from_numpy(accum), torch.from_numpy(seen),
            dn.DensifyConfig(**dck))
    a = dn.densify_and_prune(*args, generator=torch.Generator().manual_seed(4))
    b = dn.densify_and_prune(*args, generator=torch.Generator().manual_seed(4))
    c = dn.densify_and_prune(
        *args, normals=dn.split_normals(cap, torch.Generator().manual_seed(4)))
    d = dn.densify_and_prune(*args, generator=torch.Generator().manual_seed(5))
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]) and torch.equal(a[0][k], c[0][k]), k
    assert not torch.equal(a[0]["means"], d[0]["means"])


def _adam_states(padded, g=0.1):
    """The same one-step Adam state in both packages."""
    tc = trainer.TrainConfig()
    opt = trainer.make_optimizer(tc, keys=tuple(sorted(padded)))
    state = opt.init(padded)
    _, state = opt.update({k: torch.full_like(v, g) for k, v in padded.items()}, state,
                          padded)
    jopt = jax_trainer.make_optimizer(jax_trainer.TrainConfig())
    jp = {k: jnp.asarray(v.numpy()) for k, v in padded.items()}
    jstate = jopt.init(jp)
    _, jstate = jopt.update(jax.tree.map(lambda x: jnp.full_like(x, g), jp), jstate, jp)
    return state, jstate


def _jax_moments(jstate, keys):
    """{mu|nu: {key: array}} of the JAX optax state (its inner Adam states
    are keyed by parameter name)."""
    inner = jstate.inner_states
    return {m: {k: np.asarray(getattr(inner[k].inner_state[0], m)[k]) for k in keys}
            for m in ("mu", "nu")}


def test_reset_rows_zeroes_moments():
    _, raw, _ = _raw_scene(6)
    padded, _ = dn.pad_to_capacity(raw, 8)
    state, jstate = _adam_states(padded)
    changed = torch.zeros(8, dtype=torch.bool)
    changed[2] = True
    state2 = dn.reset_rows(state, changed)
    jm = _jax_moments(jdn.reset_rows(jstate, jnp.asarray(changed.numpy())), padded)
    assert state2["count"] == state["count"] == 1
    for m in ("mu", "nu"):
        for k, leaf in state2[m].items():
            assert float(leaf[2].abs().max()) == 0.0
            assert float(leaf[1].abs().max()) > 0.0
            np.testing.assert_array_equal(leaf.numpy(), jm[m][k], err_msg=f"{m} {k}")


def test_reset_opacity_clamps_and_wipes_moments():
    jraw, raw, _ = _raw_scene(8)
    padded, _ = dn.pad_to_capacity(raw, 16)
    padded["logit_opacities"][:8] = 2.0
    out = dn.reset_opacity(padded, ceiling=0.01)
    jout = jdn.reset_opacity({k: jnp.asarray(v.numpy()) for k, v in padded.items()}, 0.01)
    for k in jout:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
    op = trainer.params_from_raw(out)["opacities"].numpy()
    assert (op[:8] <= 0.01 + 1e-6).all() and (op[8:] < 1e-6).all()
    assert torch.equal(out["means"], padded["means"])

    state, jstate = _adam_states(padded, g=1.0)
    state2 = dn.reset_opacity_moments(state, 16)
    jm = _jax_moments(jdn.reset_opacity_moments(jstate, 16), padded)
    for m in ("mu", "nu"):
        for k, leaf in state2[m].items():
            if k == "logit_opacities":
                assert float(leaf.abs().max()) == 0.0
            else:
                assert float(leaf.abs().max()) > 0.0     # the moments survive
            np.testing.assert_array_equal(leaf.numpy(), jm[m][k], err_msg=f"{m} {k}")


def test_accumulate_counts_only_visible_and_matches_jax():
    gnorm = np.array([1.0, 0.0, 5.0, 1.7], np.float32)
    alive = np.array([True, True, True, False])
    accum, seen = dn.accumulate_grad_stats(torch.zeros(4), torch.zeros(4),
                                           torch.from_numpy(gnorm), torch.from_numpy(alive))
    np.testing.assert_array_equal(accum.numpy(), [1.0, 0.0, 5.0, 0.0])
    np.testing.assert_array_equal(seen.numpy(), [1, 0, 1, 0])
    rng = np.random.default_rng(8)
    a0 = rng.uniform(0, 3, 64).astype(np.float32)
    s0 = rng.integers(0, 4, 64).astype(np.float32)
    g = (rng.uniform(0, 1, 64) * (rng.uniform(0, 1, 64) > 0.4)).astype(np.float32)
    al = rng.uniform(0, 1, 64) > 0.2
    got = dn.accumulate_grad_stats(torch.from_numpy(a0), torch.from_numpy(s0),
                                   torch.from_numpy(g), torch.from_numpy(al))
    want = jdn.accumulate_grad_stats(jnp.asarray(a0), jnp.asarray(s0), jnp.asarray(g),
                                     jnp.asarray(al))
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_accumulate_rejects_unnormed_grads():
    with pytest.raises(ValueError, match="grad norm"):
        dn.accumulate_grad_stats(torch.zeros(4), torch.zeros(4), torch.ones((4, 3)),
                                 torch.ones(4, dtype=torch.bool))


def test_accumulate_matches_batched():
    rng = np.random.default_rng(3)
    alive = torch.tensor([True, True, False, True])
    norms = [torch.from_numpy((rng.uniform(0, 1, 4) * (rng.uniform(0, 1, 4) > 0.3))
                              .astype(np.float32)) for _ in range(3)]
    a_seq, s_seq = torch.zeros(4), torch.zeros(4)
    for g in norms:
        a_seq, s_seq = dn.accumulate_grad_stats(a_seq, s_seq, g, alive)
    gsum = sum(torch.where(g > 0, g, 0.0) for g in norms)
    sinc = sum((g > 0).float() for g in norms)
    a_b, s_b = dn.accumulate_grad_stats_batched(torch.zeros(4), torch.zeros(4), gsum,
                                                sinc, alive)
    np.testing.assert_allclose(a_seq.numpy(), a_b.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(s_seq.numpy(), s_b.numpy())
    ja, js = jdn.accumulate_grad_stats_batched(
        jnp.zeros(4), jnp.zeros(4), jnp.asarray(gsum.numpy()), jnp.asarray(sinc.numpy()),
        jnp.asarray(alive.numpy()))
    np.testing.assert_array_equal(a_b.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(s_b.numpy(), np.asarray(js))


def _fit_target(n=20, seed=11):
    scene = jax_ply.make_synthetic_scene(n, seed=seed, extent=1.2)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    scene["opacities"] = np.clip(scene["opacities"], 0.5, 0.9)
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    target = render_stats(convert.params_from_numpy(scene, "cpu"), cam, CFG)[0]
    return scene, cam, target[..., :3].numpy()


def test_fit_adaptive_end_to_end():
    """Start under-parameterised and densify during the fit: the live set
    grows and the fit improves on the starting PSNR."""
    scene, cam, target = _fit_target()
    start = {k: v[:6] for k, v in scene.items()}
    img0 = render_stats(convert.params_from_numpy(start, "cpu"), cam, KCFG)[0]
    psnr0 = float(losses.psnr(img0[..., :3], torch.from_numpy(target)))
    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6, scene_extent=1.2,
                          start_step=0, interval=30, stop_step=100)
    tc = trainer.TrainConfig(steps=150, lambda_dssim=0.0, lr_means=3e-3,
                             lr_scales=2e-2, lr_opacities=1e-1, lr_colors=2.0)
    fitted, alive, hist = dn.fit_scene_adaptive(
        start, [target], [cam], KCFG, dc, tc=tc, verbose=False, log_every=75,
        device="cpu")
    assert int(alive.sum()) > 6, "densification never allocated"
    assert [h["step"] for h in hist] == [0, 75, 149]
    assert set(hist[0]) == {"step", "loss", "psnr", "alive", "wall_s"}
    imgf = render_stats(fitted, cam, KCFG)[0]
    psnrf = float(losses.psnr(imgf[..., :3], torch.from_numpy(target)))
    assert psnrf > psnr0 + 0.4, (psnr0, psnrf)
    compact = dn.compact_params(fitted, alive)
    assert compact["means"].shape[0] == int(alive.sum())


def test_checkpoint_roundtrip_with_densify_state(tmp_path):
    _, raw, _ = _raw_scene(6)
    padded, alive = dn.pad_to_capacity(raw, 8)
    accum = torch.arange(8, dtype=torch.float32) * 0.5
    seen = torch.ones(8)
    p = str(tmp_path / "ck.npz")
    gen = torch.Generator().manual_seed(2)
    trainer.save_checkpoint(p, padded, step=17, alive=alive, grad_accum=accum,
                            seen_count=seen, rng_state=gen.get_state())
    raw2, step = trainer.load_checkpoint(p)
    assert step == 17 and set(raw2) == set(padded)
    np.testing.assert_array_equal(raw2["means"], padded["means"].numpy())
    _, step3, extras = trainer.load_checkpoint_full(p)
    assert step3 == 17
    np.testing.assert_array_equal(extras["alive"], alive.numpy())
    np.testing.assert_array_equal(extras["grad_accum"], accum.numpy())
    np.testing.assert_array_equal(extras["seen_count"], seen.numpy())
    g2 = torch.Generator()
    g2.set_state(torch.from_numpy(extras["rng_state"]))
    assert torch.equal(torch.randn(5, generator=g2), torch.randn(5, generator=gen))


def test_adaptive_fit_with_opacity_reset():
    _, raw, params = _raw_scene(10, seed=5, extent=1.0)
    p = trainer.params_from_raw(raw)
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    target = render_stats(p, cam, KCFG)[0][..., :3].numpy()
    tc = trainer.TrainConfig(steps=21, lambda_dssim=0.0)
    dc = dn.DensifyConfig(capacity=16, grad_threshold=1e9, scene_extent=1.0,
                          start_step=1000, opacity_reset_interval=20)
    fitted, alive, _ = dn.fit_scene_adaptive(p, [target], [cam], KCFG, dc, tc=tc,
                                             verbose=False, log_every=10, device="cpu")
    op = fitted["opacities"][alive].numpy()
    assert (op <= 0.01 + 1e-6).all(), op.max()


def test_adaptive_kill_and_resume_matches(tmp_path):
    """A checkpoint between densify events resumes to the uninterrupted
    run bit for bit: params, optimizer, alive mask, statistics and the
    generator's state all round-trip (the densify at step 6 splits, so
    the draws matter)."""
    scene, cam, target = _fit_target()
    start = {k: v[:6] for k, v in scene.items()}
    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6, scene_extent=1.2,
                          start_step=0, interval=6, stop_step=10)
    tc = trainer.TrainConfig(steps=10, lambda_dssim=0.0, lr_means=3e-3)
    events = []
    ref, alive_ref, _ = dn.fit_scene_adaptive(
        start, [target], [cam], KCFG, dc, tc=tc, seed=3, verbose=False, device="cpu",
        on_densify=lambda i, before, after, stats: events.append((i, dict(stats))))
    assert [i for i, _ in events] == [6] and int(events[0][1]["split"]) > 0, events
    mid = str(tmp_path / "ad.ckpt.npz")
    tc4 = dataclasses.replace(tc, steps=4)
    dn.fit_scene_adaptive(start, [target], [cam], KCFG, dc, tc=tc4, seed=3,
                          verbose=False, save_every=4, checkpoint_path=mid, device="cpu")
    res, alive_res, _ = dn.fit_scene_adaptive(start, [target], [cam], KCFG, dc, tc=tc,
                                              seed=3, verbose=False, resume=mid,
                                              device="cpu")
    assert torch.equal(alive_ref, alive_res)
    for k in ref:
        assert torch.equal(ref[k], res[k]), f"adaptive resume diverged on {k}"
    with pytest.raises(ValueError, match="densify state"):
        plain = str(tmp_path / "plain.npz")
        trainer.save_checkpoint(plain, dn.pad_to_capacity(
            trainer.raw_from_params(convert.params_from_numpy(start, "cpu")), 24)[0])
        dn.fit_scene_adaptive(start, [target], [cam], KCFG, dc, tc=tc, verbose=False,
                              resume=plain, device="cpu")


# ---- the split-free adaptive fit against the JAX package ----------------

E2E_DC = dict(capacity=32, grad_threshold=4e-3, percent_dense=0.2,
              scene_extent=1.2, start_step=2, interval=2, stop_step=6)
E2E_STEPS = 6


def _recording(module, calls):
    real = module.densify_and_prune

    def rec(raw, alive, grad_accum, seen_count, *a, **kw):
        out = real(raw, alive, grad_accum, seen_count, *a, **kw)
        calls.append({"avg": np.asarray(grad_accum) / np.maximum(np.asarray(seen_count), 1.0)
                      if not torch.is_tensor(grad_accum)
                      else (grad_accum / seen_count.clamp_min(1.0)).numpy(),
                      "alive_in": np.asarray(alive) if not torch.is_tensor(alive)
                      else alive.numpy(),
                      "alive": np.asarray(out[1]) if not torch.is_tensor(out[1])
                      else out[1].numpy()})
        return out
    return rec


def _e2e_inputs():
    scene, _, _ = _fit_target(n=20, seed=11)
    noisy = dict(scene)
    noisy["colors"] = np.clip(scene["colors"] + np.random.default_rng(0).normal(
        0, 60, scene["colors"].shape), 5, 250).astype(np.float32)
    noisy["opacities"] = np.where(np.arange(20) == 4, 0.004, scene["opacities"]
                                  ).astype(np.float32)     # one splat to prune
    return scene, noisy


@pytest.fixture(scope="module")
def jax_adaptive(tmp_path_factory):
    """The JAX package's fit_scene_adaptive on 20 splats at 64x64, capacity
    32, densifying at steps 2 and 4 without splits: what each densify saw
    and returned, the history, and a checkpoint after every step."""
    scene, noisy = _e2e_inputs()
    jcfg = JaxConfig(**OPTS)
    cam = JaxCamera(0.0, 0.0, -4.0, width=W, height=H)
    target = np.asarray(jax_render_stats({k: jnp.asarray(v) for k, v in scene.items()},
                                         cam, jcfg)[0][..., :3])
    calls, saved = [], {}
    real_save = jax_trainer.save_checkpoint
    base = str(tmp_path_factory.mktemp("jax_adaptive") / "ck")

    def save(path, raw, step=0, **kw):
        saved[step] = f"{base}{step}.npz"
        real_save(saved[step], raw, step=step, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jdn, "densify_and_prune", _recording(jdn, calls))
    mp.setattr(jax_trainer, "save_checkpoint", save)
    try:
        fitted, alive, hist = jdn.fit_scene_adaptive(
            {k: jnp.asarray(v) for k, v in noisy.items()}, [target], [cam], jcfg,
            jdn.DensifyConfig(**E2E_DC), tc=jax_trainer.TrainConfig(steps=E2E_STEPS),
            seed=0, log_every=1, verbose=False, save_every=1, checkpoint_path=base)
    finally:
        mp.undo()
    return dict(target=target, noisy=noisy, calls=calls, saved=saved, hist=hist,
                alive=np.asarray(alive), fitted={k: np.asarray(v) for k, v in fitted.items()})


def test_fit_adaptive_matches_jax(jax_adaptive, monkeypatch):
    j = jax_adaptive
    # no statistic within 1% of the threshold, so rounding cannot flip a pick
    thr = E2E_DC["grad_threshold"]
    for c in j["calls"]:
        live = c["avg"][c["alive_in"]]
        assert not np.any(np.abs(live - thr) <= 0.01 * thr), live
    assert len(j["calls"]) == 2
    assert int(j["calls"][0]["alive"].sum()) > 19, "nothing cloned"
    calls = []
    monkeypatch.setattr(dn, "densify_and_prune", _recording(dn, calls))
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    fitted, alive, hist = dn.fit_scene_adaptive(
        j["noisy"], [j["target"]], [cam], CFG, dn.DensifyConfig(**E2E_DC),
        tc=trainer.TrainConfig(steps=E2E_STEPS), log_every=1, verbose=False,
        device="cpu")
    assert len(calls) == 2
    for c, jc in zip(calls, j["calls"]):
        np.testing.assert_array_equal(c["alive"], jc["alive"])
    np.testing.assert_array_equal(alive.numpy(), j["alive"])
    assert [h["step"] for h in hist] == [h["step"] for h in j["hist"]]
    for h, jh in zip(hist, j["hist"]):
        assert abs(h["loss"] - jh["loss"]) <= 1e-4 * abs(jh["loss"]), (h, jh)
        assert h["alive"] == jh["alive"]


def test_jax_checkpoint_resumes_in_the_port(jax_adaptive, capsys):
    """A checkpoint the JAX package wrote after step 3 (past the densify at
    step 2) continues in the port: raw, Adam leaves, alive and the
    statistics load; the draws cannot, and the run says so."""
    j = jax_adaptive
    cam = port.Camera(0.0, 0.0, -4.0, width=W, height=H)
    fitted, alive, hist = dn.fit_scene_adaptive(
        j["noisy"], [j["target"]], [cam], CFG, dn.DensifyConfig(**E2E_DC),
        tc=trainer.TrainConfig(steps=E2E_STEPS), log_every=1, verbose=False,
        resume=j["saved"][3], device="cpu")
    assert "not the JAX run's" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [3, 4, 5]
    np.testing.assert_array_equal(alive.numpy(), j["alive"])
    for h, jh in zip(hist, j["hist"][3:]):
        assert abs(h["loss"] - jh["loss"]) <= 1e-4 * abs(jh["loss"]), (h, jh)
    for k, want in j["fitted"].items():
        assert _rel(fitted[k], want) <= 1e-4, k


# ---- the screen statistic against autodiff through the oracle ------------

def test_train_step_screen_statistic_matches_autodiff_oracle():
    """The train step's grad_stat="screen" metric equals the gradient of a
    zero shift added to the oracle's mean2d, scaled to NDC units, as
    tests/test_densify_trigger.py holds the JAX step."""
    w = h = 128
    cfg = port.RenderConfig.for_resolution(w, h, tile_px=32, use_pallas=False,
                                           max_per_tile=512, chunk=64,
                                           dup_capacity_factor=24.0)
    rng = np.random.default_rng(8)
    scene = jax_ply.make_synthetic_scene(150, seed=8, extent=1.2)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    scene["means"][:, 2] = rng.uniform(-1.5, 8.0, 150).astype(np.float32)
    # the step round-trips through raw space: the oracle sees the same
    params = trainer.params_from_raw(trainer.raw_from_params(
        convert.params_from_numpy(scene, "cpu")))
    a = camera_args(port.Camera(0.0, 0.0, -4.0, width=w, height=h))
    view, vp = torch.from_numpy(a["view"]), torch.from_numpy(a["vp"])
    target = torch.zeros((h, w, 3))

    delta = torch.zeros((150, 2), requires_grad=True)
    cov6 = build_covariance(params["scales"], params["quats"])
    prep = projection.preprocess(params["means"], cov6, params["opacities"], view, vp,
                                 w, h, a["focal_x"], a["focal_y"], a["tan_fovx"],
                                 a["tan_fovy"], cfg)
    recs = binning.expand_records(prep["counts"], prep["tile_min"], prep["tile_ext"],
                                  prep["depth"].detach(), cfg, cfg.capacity(150))
    sorted_sid, bounds = binning.sort_and_bin(recs, cfg)
    prep = dict(prep, mean2d=prep["mean2d"] + delta)
    img, _ = compositing.composite(
        compositing.gather_records(prep, params["colors"], sorted_sid), bounds, w, h, cfg)
    (g2d,) = torch.autograd.grad(((img[..., :3] - target) ** 2).mean(), delta)
    want = torch.linalg.vector_norm(g2d * torch.tensor([w / 2.0, h / 2.0]), dim=-1)
    assert int((want > 0).sum()) > 50

    step = trainer.make_train_step(cfg, trainer.TrainConfig(steps=1), w, h,
                                   loss_fn=lambda p, t: ((p - t) ** 2).mean(),
                                   with_grad_norms=True, grad_stat="screen")
    state = step.init(trainer.raw_from_params(convert.params_from_numpy(scene, "cpu")))
    _, metrics = step(state, target, view, vp, a["focal_x"], a["focal_y"],
                      a["tan_fovx"], a["tan_fovy"])
    np.testing.assert_allclose(metrics["densify_grad_norm"].numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-10)


def test_fit_scene_adaptive_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    scene, cam, target = _fit_target()
    with pytest.raises((RuntimeError, AssertionError)):
        dn.fit_scene_adaptive(scene, [target], [cam], CFG,
                              dn.DensifyConfig(capacity=32),
                              tc=trainer.TrainConfig(steps=1), verbose=False)
