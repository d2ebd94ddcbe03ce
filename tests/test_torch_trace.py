"""The port's ``gs.*`` spans (``utils.timing.span``) on the CPU.

With no profiler recording, a span is one shared no-op and no
``record_function`` is entered. Under ``torch.profiler`` a fast-path frame
is one ``gs.frame`` range holding the frame's stages in order, and a
training step one ``gs.step`` range holding the forward stages, the loss,
every backward stage and Adam; no stage range lies inside another. The
kernels' plain versions run here, so the frame and the step take the same
Python path as on a card.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.camera import Camera
from openglgaussiansplattingrenderer_tpu_torch.io import ply
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train import trainer
from openglgaussiansplattingrenderer_tpu_torch.utils import timing
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

W = H = 64
CFG = dict(chunk=32, max_per_tile=256, dup_capacity_factor=32.0, use_pallas=True)
ROOTS = ("gs.frame", "gs.step")
FRAME = ["gs.table", "gs.scan", "gs.expand", "gs.sort", "gs.composite"]
HOISTED = ["gs.table", "gs.sort", "gs.scan", "gs.expand", "gs.sort", "gs.composite"]


def scene():
    s = ply.make_synthetic_scene(25, seed=6, extent=1.2)
    s["opacities"] = s["opacities"].clip(0.4, 0.9)
    return {k: torch.from_numpy(v) for k, v in s.items() if k != "sh_rest"}


def camera():
    a = camera_args(Camera(0.0, 0.0, -4.0, width=W, height=H))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"])


def spans(prof):
    """(name, start, end) of every ``gs.*`` range the profiler kept, in
    start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("gs.")), key=lambda s: s[1])


def check_nesting(got):
    """One root, every other range inside it, no stage inside another."""
    root = got[0]
    assert root[0] in ROOTS and not [s for s in got[1:] if s[0] == root[0]]
    assert all(root[1] <= a and b <= root[2] for _, a, b in got[1:])
    stages = [s for s in got if s[0] not in ROOTS]
    for (n0, _, b0), (n1, a1, _) in zip(stages, stages[1:]):
        assert b0 <= a1, (n0, n1)


def frame_spans(cfg):
    params, cam = scene(), camera()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_arrays(params, *cam, W, H, cfg)
    return spans(prof)


def test_span_off_is_one_shared_no_op(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: pytest.fail(f"{name} entered with no profiler on"))
    off = timing.span("gs.frame")
    assert off is timing.span("gs.step")
    with off:
        pass
    img, _ = render_arrays(scene(), *camera(), W, H, port.RenderConfig(**CFG))
    assert img.shape == (H, W, 4)


@pytest.mark.parametrize("hoist, want", [(False, FRAME), (True, HOISTED)],
                         ids=["pair", "hoist_depth_sort"])
def test_frame_is_one_root_over_its_stages_in_order(hoist, want):
    """Under ``hoist_depth_sort`` the frame sorts twice (the splat table by
    depth before the prefix sum, the records by tile after the expansion):
    both are the sort stage."""
    got = frame_spans(port.RenderConfig(**CFG, hoist_depth_sort=hoist))
    assert [n for n, _, _ in got] == ["gs.frame"] + want
    check_nesting(got)


BACKWARD = ["gs.loss.bwd", "gs.composite.bwd", "gs.sort.bwd", "gs.segsum", "gs.table.bwd"]
HOISTED_BACKWARD = ["gs.loss.bwd", "gs.composite.bwd", "gs.sort.bwd", "gs.segsum",
                    "gs.sort.bwd", "gs.table.bwd"]


@pytest.mark.parametrize("over, forward, backward", [
    ({}, FRAME, BACKWARD),
    ({"hoist_depth_sort": True}, HOISTED, HOISTED_BACKWARD),
    ({"hoist_depth_sort": True, "record_sort": "radix"}, HOISTED, HOISTED_BACKWARD),
], ids=["pair", "hoist_depth_sort", "hoist_radix"])
def test_step_is_one_root_over_every_stage(monkeypatch, over, forward, backward):
    # the loss kernels' autograd function on CPU tensors, with their plain
    # restatements in place of the launches, so its backward runs here
    monkeypatch.setattr(kl, "check_inputs", lambda pred, target: True)
    monkeypatch.setattr(kl, "gs_loss_fwd", lambda pred, target, lam: (
        kl.gs_loss_separable_plain(pred, target, lam), torch.empty(0)))
    monkeypatch.setattr(kl, "gs_loss_bwd", lambda pred, target, work, dloss, lam:
                        kl.gs_loss_separable_bwd_plain(pred, target, dloss, lam))
    params, cam = scene(), camera()
    cfg = port.RenderConfig(**CFG, **over)
    step = trainer.make_train_step(cfg, trainer.TrainConfig(), W, H)
    state = step.init(trainer.raw_from_params(params))
    target = torch.full((H, W, 3), 0.5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, target, *(torch.from_numpy(m) for m in cam[:2]),
                              *cam[2:])
    assert torch.isfinite(metrics["loss"]) and state.step == 1
    got = spans(prof)
    assert [n for n, _, _ in got] == (["gs.step", "gs.frame"] + forward + ["gs.loss"]
                                      + backward + ["gs.adam"])
    check_nesting(got)
    frame = got[1]
    inside = [n for n, a, b in got[2:] if frame[1] <= a and b <= frame[2]]
    assert inside == forward
