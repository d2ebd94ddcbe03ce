"""The port's adaptive step (``train.densify.make_adaptive_step``) on the
CPU: bit-equal to the adaptive loop written out from its parts and to
``fit_scene_adaptive``; its densify event against the benchmark's plain
reference (``benchmark/reference/densify.py``) on seeded random scenes,
with the draws from one generator state; the screen statistic against
the reference's and against a finite difference; the step's ``overflow``
metric; the densify counters.

Tolerances: the adaptive step, the loop and ``fit_scene_adaptive`` run
the same operations in the same order, so bit-equal; the event's live
and changed rows and its counts exact (the selection is the same float32
arithmetic on both sides), its tensors within 1e-6 of each tensor's
largest magnitude (the split offsets go through another rotation
formula); the statistic within 1e-4 of the reference's norm (two
compositor backwards that sum in another order, a float64 loss against
the port's float32 one); the finite difference within 1e-3 (a float64
loss of float32 frames differenced over a 0.1 px shift; it read 1e-4).
"""

import dataclasses

import pytest
import torch

import openglgaussiansplattingrenderer_tpu_torch as port
from benchmark.reference import densify as rd
from benchmark.reference import render as rr
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
from openglgaussiansplattingrenderer_tpu_torch.train import trainer
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = H = 64
KCFG = port.RenderConfig.for_resolution(W, H, tile_px=16, use_pallas=True, chunk=32,
                                        max_per_tile=256, dup_capacity_factor=32.0)
FRAME = rr.Frame(width=W, height=H, tile_px=16)


def _raw(n, seed, **kw):
    """Raw splats in front of the camera at (0, 0, -4): means in the unit
    box, log-scales in [lo, hi], opacity logits N(0, sigma)."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = kw.get("log_scales", (-3.5, -2.0))
    return {"means": torch.rand((n, 3), generator=g) * 2.0 - 1.0,
            "log_scales": lo + (hi - lo) * torch.rand((n, 3), generator=g),
            "quats": torch.randn((n, 4), generator=g),
            "logit_opacities": kw.get("logit_sigma", 1.0) * torch.randn((n,), generator=g),
            "colors": 255.0 * torch.rand((n, 3), generator=g)}


def _camera():
    a = camera_args(port.Camera(0.0, 0.0, -4.0, width=W, height=H))
    return a, (torch.from_numpy(a["view"]), torch.from_numpy(a["vp"]), a["focal_x"],
               a["focal_y"], a["tan_fovx"], a["tan_fovy"])


def _target(seed=4):
    g = torch.Generator().manual_seed(seed)
    return 0.1 + 0.8 * torch.rand((H, W, 3), generator=g)


TC = trainer.TrainConfig(lambda_dssim=0.2, lr_means=3e-3)
DC = dn.DensifyConfig(capacity=40, grad_threshold=2e-6, percent_dense=0.1, scene_extent=1.0,
                      start_step=0, interval=3, stop_step=9, opacity_reset_interval=5,
                      big_scale_frac=0.12, big_prune_after=4)


def _loop(raw, target, bundle, steps, seed):
    """The adaptive loop body written out from its parts."""
    step = trainer.make_train_step(KCFG, TC, W, H, with_grad_norms=True,
                                   param_keys=tuple(sorted(raw)))
    padded, alive = dn.pad_to_capacity(raw, DC.capacity)
    state = step.init(padded)
    accum = torch.zeros(DC.capacity)
    seen = torch.zeros(DC.capacity)
    gen = dn._seeded_generator("cpu", seed, 0)
    losses_, events = [], []
    for i in range(steps):
        state, m = step(state, target, *bundle)
        losses_.append(m["loss"])
        accum, seen = dn.accumulate_grad_stats(accum, seen, m["densify_grad_norm"], alive)
        if DC.start_step <= i < DC.stop_step and i > 0 and i % DC.interval == 0:
            raw_i, alive, changed, st = dn.densify_and_prune(state.raw, alive, accum, seen, DC,
                                                             generator=gen, iteration=i)
            state = trainer.TrainState(raw_i, dn.reset_rows(state.opt_state, changed),
                                       state.step)
            accum, seen = torch.zeros_like(accum), torch.zeros_like(seen)
            events.append((i, {k: int(v) for k, v in st.items()}))
        if DC.opacity_reset_interval and 0 < i < DC.stop_step and i % DC.opacity_reset_interval == 0:
            state = trainer.TrainState(dn.reset_opacity(state.raw, DC.opacity_reset_ceiling),
                                       dn.reset_opacity_moments(state.opt_state, DC.capacity),
                                       state.step)
    return state, alive, accum, seen, losses_, events


def test_adaptive_step_is_the_loop_and_fit_scene_adaptive():
    params = trainer.params_from_raw(_raw(24, 1))
    raw = trainer.raw_from_params(params)    # as fit_scene_adaptive makes it
    target = _target()
    _, bundle = _camera()
    steps = 9
    want = _loop(raw, target, bundle, steps, seed=5)
    assert [i for i, _ in want[5]] == [3, 6]
    assert all(st["cloned"] + st["split"] > 0 for _, st in want[5]), want[5]
    assert any(st["split"] > 0 for _, st in want[5]), want[5]

    events = []
    step = dn.make_adaptive_step(KCFG, TC, W, H, DC, tuple(sorted(raw)), seed=5,
                                 on_densify=lambda i, b, a, st: events.append(
                                     (i, {k: int(v) for k, v in st.items()})))
    state = step.init(raw)
    got_losses = []
    for _ in range(steps):
        state, m = step(state, target, *bundle)
        got_losses.append(m["loss"])
    assert step.iteration == steps and events == want[5]
    assert torch.equal(step.alive, want[1])
    assert torch.equal(step.grad_accum, want[2]) and torch.equal(step.seen_count, want[3])
    assert all(torch.equal(a, b) for a, b in zip(got_losses, want[4]))
    for k in raw:
        assert torch.equal(state.raw[k], want[0].raw[k]), k
        for mom in ("mu", "nu"):
            assert torch.equal(state.opt_state[mom][k], want[0].opt_state[mom][k]), (mom, k)

    tc = dataclasses.replace(TC, steps=steps)
    fitted, alive, hist = dn.fit_scene_adaptive(
        params, [target], [port.Camera(0.0, 0.0, -4.0, width=W, height=H)], KCFG, DC,
        tc=tc, seed=5,
        log_every=4, verbose=False, device="cpu")
    assert torch.equal(alive, want[1])
    for k, v in trainer.params_from_raw(want[0].raw).items():
        assert torch.equal(fitted[k], v), k
    assert [h["loss"] for h in hist] == [float(want[4][i]) for i in (0, 4, 8)]


EVENTS = {
    # name: (live rows of 64, iteration, settings), every row a candidate
    # at threshold 0 in "crowded"
    "crowded": (60, 10, dict(grad_threshold=0.0)),
    "world_prune_before": (40, 3000, dict(big_scale_frac=0.1, big_prune_after=3000)),
    "world_prune_after": (40, 3001, dict(big_scale_frac=0.1, big_prune_after=3000)),
    "split_and_clone": (32, 7, dict()),
}


@pytest.mark.parametrize("name", sorted(EVENTS))
def test_event_matches_the_reference(name):
    live, it, over = EVENTS[name]
    cap, extent = 64, 2.0
    s = dict(grad_threshold=0.05, percent_dense=0.03, min_opacity=0.005, split_factor=1.6,
             big_scale_frac=0.0, big_prune_after=0)
    s.update(over)
    dc = dn.DensifyConfig(capacity=cap, scene_extent=extent, statistic="screen", **s)
    raw, alive = dn.pad_to_capacity(_raw(live, 11, log_scales=(-4.5, -1.0), logit_sigma=3.0),
                                    cap)
    raw["logit_opacities"][0] = -8.0          # one transparent splat to prune
    g = torch.Generator().manual_seed(23)
    accum = torch.rand(cap, generator=g) * 0.3 * alive
    seen = torch.randint(0, 4, (cap,), generator=g).float() * alive
    mu = {k: torch.randn(v.shape, generator=g) for k, v in raw.items()}
    nu = {k: torch.rand(v.shape, generator=g) for k, v in raw.items()}

    ours = torch.Generator().manual_seed(99)
    theirs = torch.Generator()
    theirs.set_state(ours.get_state())
    out, now, changed, st = dn.densify_and_prune(raw, alive, accum, seen, dc, generator=ours,
                                                 iteration=it)
    opt = dn.reset_rows({"count": 3, "mu": mu, "nu": nu}, changed)
    ref = rd.event(raw, alive, accum, seen, mu, nu, theirs, s, extent, it)

    assert torch.equal(now, ref["alive"]) and torch.equal(changed, ref["changed"])
    assert {k: int(v) for k, v in st.items()} == ref["stats"]
    for group, mine in (("raw", out), ("mu", opt["mu"]), ("nu", opt["nu"])):
        for k, want in ref[group].items():
            scale = float(want.abs().max())
            assert float((mine[k] - want).abs().max()) <= 1e-6 * scale, (group, k)
    assert torch.equal(ours.get_state(), theirs.get_state())

    clear = alive & (torch.sigmoid(raw["logit_opacities"]) < 0.005)
    big = alive & ~clear & (torch.exp(raw["log_scales"]).amax(1) > 0.1 * extent)
    stats = ref["stats"]
    assert int(clear.sum()) > 0
    if name == "crowded":
        assert int((alive & (seen > 0)).sum()) > cap - live
        assert stats["cloned"] + stats["split"] == int((~alive).sum()) + stats["pruned"]
    elif name.startswith("world_prune"):
        after = name == "world_prune_after"
        assert int(big.sum()) > 0 and bool(changed[big].all()) == after
        assert stats["pruned"] == int(clear.sum()) + after * int(big.sum())
    else:
        assert stats["cloned"] > 0 and stats["split"] > 0
    for k in ("mu", "nu"):
        assert float(opt[k]["means"][changed].abs().max()) == 0.0


def _scene_and_step():
    raw = _raw(150, 8)
    target = _target(6)
    cam, bundle = _camera()
    return raw, target, cam, bundle


def _mse64(pred, target):
    return ((pred.double() - target.double()) ** 2).mean()


def test_screen_statistic_matches_the_reference_and_a_finite_difference():
    raw, target, cam, bundle = _scene_and_step()
    step = trainer.make_train_step(KCFG, TC, W, H, with_grad_norms=True,
                                   param_keys=tuple(raw))
    _, m = step(step.init(raw), target, *bundle)
    got = m["densify_grad_norm"]
    want = rd.screen_statistic(raw, target, cam, FRAME, TC.lambda_dssim)
    assert int((want > 0).sum()) > 50
    assert float(torch.linalg.vector_norm(got - want)) <= 1e-4 * float(
        torch.linalg.vector_norm(want))
    assert torch.equal(got > 0, want > 0)

    # the statistic of a float64 loss against its central difference, on six
    # splats large enough that their 3-sigma rectangles and 1/255 alpha floors
    # lie outside the frame: a shift moves no pixel across either edge, whose
    # jumps the gradient (3DGS's too) leaves out
    g = torch.Generator().manual_seed(3)
    big = {"means": (torch.rand((6, 3), generator=g) - 0.5) * 0.6,
           "log_scales": 1.0 + 0.3 * torch.rand((6, 3), generator=g),
           "quats": torch.randn((6, 4), generator=g),
           "logit_opacities": torch.full((6,), -0.85),
           "colors": 255.0 * torch.rand((6, 3), generator=g)}
    step = trainer.make_train_step(KCFG, TC, W, H, loss_fn=_mse64, with_grad_norms=True,
                                   param_keys=tuple(big))
    _, m = step(step.init(big), target, *bundle)
    got = m["densify_grad_norm"]
    params = trainer.params_from_raw(big)
    h = 0.1

    def loss_at(shift):
        img, _ = render_arrays(dict(params, shift2d=shift), *bundle, W, H, KCFG)
        return float(_mse64(img[..., :3], target))

    for i in range(6):
        d = []
        for axis in (0, 1):
            e = torch.zeros((6, 2))
            e[i, axis] = h
            d.append((loss_at(e) - loss_at(-e)) / (2.0 * h))
        fd = ((d[0] * W / 2.0) ** 2 + (d[1] * H / 2.0) ** 2) ** 0.5
        assert abs(fd - float(got[i])) <= 1e-3 * float(got[i]), (i, fd, float(got[i]))


def test_overflow_metric_reports_dropped_records():
    """A step at the least capacity the frame takes (one expand grid's 4,096
    records) drops records of these 1,000 large splats, and says so."""
    raw = _raw(1000, 8, log_scales=(-1.5, -0.8))
    target = _target(6)
    _, bundle = _camera()
    for cap, dropped in ((None, False), (1, True)):
        cfg = KCFG if cap is None else dataclasses.replace(KCFG, capacity_records=cap)
        step = trainer.make_train_step(cfg, TC, W, H, param_keys=tuple(raw))
        _, m = step(step.init(raw), target, *bundle)
        assert m["overflow"].ndim == 0
        assert (int(m["overflow"]) > 0) == dropped, cap


def test_the_densify_counters_count_each_call():
    raw, target, _, bundle = _scene_and_step()
    dc = dataclasses.replace(DC, capacity=160, start_step=0, interval=2,
                             opacity_reset_interval=3)
    step = dn.make_adaptive_step(KCFG, TC, W, H, dc, tuple(raw), seed=2)
    state = step.init(raw)
    fns = (dn.densify_and_prune, dn.accumulate_grad_stats, dn.reset_opacity)
    before = [f.calls for f in fns]
    for _ in range(4):             # iterations 0-3: an event at 2, a reset at 3
        state, _ = step(state, target, *bundle)
    assert [f.calls - b for f, b in zip(fns, before)] == [1, 4, 1]
    dn.reset_opacity(state.raw)
    assert dn.reset_opacity.calls - before[2] == 2
