"""The benchmark's plain reference against the port's own plain oracle
(``render_arrays(use_pallas=False)``, its conv-form loss and its Adam) at
a tiny size on the CPU. The test may import both; the reference imports
nothing of the port."""

from __future__ import annotations

import ast
import dataclasses
import json

import pytest
import torch
from conftest import BENCH, shrink_config

import openglgaussiansplattingrenderer_tpu_torch as gs
from benchmark import scenes
from benchmark.reference import render as rr
from benchmark.reference import train as rt
from openglgaussiansplattingrenderer_tpu_torch.train import losses as gs_losses
from openglgaussiansplattingrenderer_tpu_torch.train import trainer as gs_trainer

pytestmark = pytest.mark.usefixtures("threads")


@pytest.fixture
def threads():
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


def tiny_cfg(name: str, **over) -> dict:
    cfg = shrink_config(json.loads((BENCH / "configs" / f"{name}.json").read_text()))
    cfg.update(over)
    return cfg


def oracle_cfg(cfg: dict) -> gs.RenderConfig:
    return gs.RenderConfig.for_resolution(cfg["width"], cfg["height"],
                                          tile_px=cfg["render"]["tile_px"],
                                          sh_degree=cfg["sh_degree"], use_pallas=False,
                                          max_per_tile=1 << 16)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert all(n.split(".")[0] in ("torch", "benchmark", "__future__", "contextlib",
                                       "dataclasses", "math", "typing") for n in names), \
            (path.name, names)


@pytest.mark.parametrize("name", ["bike-big", "mipnerf360-bicycle"])
@pytest.mark.parametrize("az", [0.0, 137.0])
def test_frame_matches_the_ports_oracle(name, az):
    cfg = tiny_cfg(name)
    params = scenes.activated(scenes.raw_scene(cfg, 2 ** 35 + 3, "cpu"))
    cam = scenes.camera(cfg, az, 12.0)
    img, total = rr.render(params, cam, rr.frame_of(cfg))
    ref_img, st = gs.render_arrays(params, cam["view"], cam["vp"], cam["focal_x"],
                                   cam["focal_y"], cam["tan_fovx"], cam["tan_fovy"],
                                   cfg["width"], cfg["height"], oracle_cfg(cfg))
    assert total == int(st["num_records"]) and total > 1000
    assert float((img - ref_img).abs().max()) < 1e-5


def test_blocks_of_any_size_give_the_same_frame():
    cfg = tiny_cfg("mipnerf360-bicycle")
    params = scenes.activated(scenes.raw_scene(cfg, 9, "cpu"))
    cam = scenes.camera(cfg, 40.0, 0.0)
    big, _ = rr.render(params, cam, rr.frame_of(cfg))
    small, _ = rr.render(params, cam, rr.frame_of(cfg), pair_budget=1 << 12)
    assert float((big - small).abs().max()) < 1e-6


@pytest.mark.parametrize("name", ["bike-big", "mipnerf360-bicycle"])
def test_loss_gradient_and_adam_match_the_ports_oracle(name):
    cfg = tiny_cfg(name)
    raw = scenes.raw_scene(cfg, 77, "cpu")
    views = scenes.training_views(cfg)
    target = scenes.targets(cfg, 1, 77, "cpu")[0]
    cam = views[3]
    fr = rr.frame_of(cfg)
    loss, grads = rt.loss_and_gradients(raw, target, cam, fr, cfg["train"]["lambda_dssim"],
                                        pair_budget=1 << 14)

    tc = gs_trainer.TrainConfig(lambda_dssim=cfg["train"]["lambda_dssim"])
    step = gs_trainer.make_train_step(oracle_cfg(cfg), tc, cfg["width"], cfg["height"],
                                      loss_fn=lambda p, t: gs_losses.gs_loss_plain(p, t, 0.2),
                                      param_keys=tuple(raw))
    (bundle,) = gs_trainer.camera_bundles([cam], "cpu")
    state, m = step(step.init(dict(raw)), target, *bundle)
    assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    for k, g in grads.items():
        prog = state.opt_state["mu"][k] / 0.1
        scale = float(g.abs().max())
        assert float((prog - g).abs().max()) <= 1e-3 * scale, k
    lrs = {k: cfg["train"]["lr"][k] for k in raw}
    zeros = {k: torch.zeros_like(v) for k, v in raw.items()}
    new, _, _ = rt.adam(raw, zeros, zeros, 0, {k: state.opt_state["mu"][k] / 0.1 for k in raw},
                        lrs)
    for k in raw:
        assert float((new[k] - state.raw[k]).abs().max()) <= 1e-5 * max(1.0, lrs[k] * 10), k


def test_compositor_backward_matches_autograd_of_the_whole_frame():
    """The block-by-block backward against autograd through one block
    holding every record of every tile."""
    cfg = tiny_cfg("bike-big", splats=600)
    fr = rr.frame_of(cfg)
    params = scenes.activated(scenes.raw_scene(cfg, 5, "cpu"))
    proj = rr.project(params, scenes.camera(cfg, 10.0, 5.0), fr)
    sid, bounds, _ = rr.bin_and_sort(proj, fr)
    rec = proj["fields"].detach()[sid].contiguous()
    g_rgb = torch.randn((fr.tiles, fr.pixels_per_tile, 3), dtype=torch.float64).float()
    g_t = torch.randn((fr.tiles, fr.pixels_per_tile)).float()
    comp = rr.Compositor(fr, pair_budget=1 << 10)
    comp.forward(rec, bounds, keep=True)
    assert len(comp.plan) > 3
    got = comp.backward(rec, bounds, g_rgb, g_t)

    leaf = rec.clone().requires_grad_(True)
    one = rr.Compositor(fr, pair_budget=1 << 30)
    cnt = (bounds[1:] - bounds[:-1]).long()
    k = int(cnt.max())
    tiles = torch.arange(fr.tiles)
    pos = torch.zeros(fr.tiles, dtype=torch.long)
    idx, live = one._take(leaf, bounds[:-1].long(), cnt, pos, tiles, k)
    px, py = rr._pixel_coords(fr, "cpu")
    c, t = one._block(leaf[idx], live, torch.ones((fr.tiles, fr.pixels_per_tile)),
                      px[:, None, :], py[:, None, :])
    (want,) = torch.autograd.grad((c, t), (leaf,), (g_rgb, g_t))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_precision_rounds_only_below_float32():
    x = torch.tensor([1.0 + 2 ** -12])
    assert rr.FP32(x) is x
    assert rr.Precision(torch.bfloat16)(x).item() == 1.0
    assert dataclasses.replace(rr.FP32).dtype == torch.float32
