"""The port's training scripts in-process on the CPU at a small size
(2,000 GT splats, 64x64, 3-6 views, 20 steps), against the JAX scripts'
protocol:

- ``scripts/torch_train_bench.py``: its last JSON line is ``main``'s return
  value, with the JAX script's keys plus ``device`` and ``card``;
- ``scripts/torch_novel_view_bench.py`` in two 10-step segments (checkpoint
  and resume between them) gives the parameters, Adam state and density
  state of one uninterrupted 20-step run bit for bit;
- ``scripts/torch_nv_holdout_eval.py`` on that checkpoint gives the bench's
  final holdout PSNR and SSIM (the same renders: equal);
- ``make_poses`` against the JAX script's (imported by path): camera
  arguments within 1e-6;
- the SfM-like init against the JAX package's ``init_params_from_points``
  on the same numpy draws: exact;
- the first GT target of each bench (200-splat scene, the render config
  each JAX script builds) against the JAX package's ``render_stats``
  (Pallas in interpret mode): within 1e-4, the contract of
  ``ARCHITECTURE.md``; the capacities equal;
- the correlated colour field against the JAX script's formula: exact.
"""

import dataclasses
import functools
import importlib
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.io.colmap import (
    init_params_from_points as jax_init_params,
)
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
NV_ARGV = ["--device", "cpu", "--cap", "2000", "--gt", "2000", "--res", "64",
           "--poses", "6", "--holdout-every", "3", "--opacity-reset", "5"]
PROTOCOL = ["--device", "cpu", "--cap", "2000", "--gt", "2000", "--res", "64",
            "--poses", "6", "--holdout-every", "3"]
TRAIN_KEYS = {"cap", "gt_splats", "res", "views", "steps", "steps_per_s",
              "ms_per_step", "total_s", "final_alive", "final_train_psnr",
              "holdout_psnr", "psnr_curve"}
NV_KEYS = {"cap", "gt_splats", "res", "train_views", "holdout_views", "steps",
           "final_train_psnr", "final_holdout_psnr", "final_holdout_ssim",
           "generalisation_gap_db", "final_alive", "total_train_s", "curve"}
EVAL_KEYS = {"ckpt", "step", "alive", "holdout_psnr_mean", "holdout_ssim_mean",
             "per_pose"}


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _nv_run(tmp, segment):
    """(JSON object, checkpoint path) of a 20-step novel-view run."""
    ckpt = str(Path(tmp) / f"nv_{segment}.ckpt.npz")
    out = _script("torch_novel_view_bench").main(
        NV_ARGV + ["--steps", "20", "--segment", str(segment), "--ckpt", ckpt,
                   "--grid", str(Path(tmp) / f"grid_{segment}.png")])
    return out, ckpt


@pytest.fixture(scope="module")
def nv_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("nv"))


def test_train_bench_json_line(capsys):
    out = _script("torch_train_bench").main(
        ["--device", "cpu", "--cap", "2000", "--gt", "2000", "--res", "64",
         "--views", "3", "--steps", "20", "--log-every", "5"])
    assert _last_json(capsys) == out
    assert set(out) == TRAIN_KEYS | {"device", "card"}
    assert out["device"] == out["card"] == "cpu"
    assert out["res"] == "64x64" and out["cap"] == 2000 and out["views"] == 3
    assert [e["step"] for e in out["psnr_curve"]] == [0, 5, 10, 15, 19]
    assert out["psnr_curve"][-1]["psnr"] > out["psnr_curve"][0]["psnr"]
    assert out["final_alive"] == 1000 and np.isfinite(out["holdout_psnr"])
    assert out["ms_per_step"] == pytest.approx(1000.0 / out["steps_per_s"])


def test_novel_view_json_line_and_grid(nv_dir, capsys):
    _nv_run.cache_clear()
    out, _ = _nv_run(nv_dir, 10)
    assert _last_json(capsys) == out
    assert set(out) == NV_KEYS | {"device", "card"}
    assert out["train_views"] == 4 and out["holdout_views"] == 2
    assert [c["step"] for c in out["curve"]] == [10, 20]
    assert out["final_holdout_psnr"] == out["curve"][-1]["holdout_psnr_mean"]
    assert np.isfinite(out["final_holdout_psnr"]) and 0 < out["final_holdout_ssim"] < 1
    assert (Path(nv_dir) / "grid_10.png").stat().st_size > 0


def test_novel_view_segments_resume_bit_for_bit(nv_dir):
    seg, ckpt_seg = _nv_run(nv_dir, 10)
    one, ckpt_one = _nv_run(nv_dir, 20)
    assert len(seg["curve"]) == 2 and len(one["curve"]) == 1
    a, b = np.load(ckpt_seg), np.load(ckpt_one)
    assert set(a.files) == set(b.files) and int(a["step"]) == 20
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert seg["final_holdout_psnr"] == one["final_holdout_psnr"]


def test_holdout_eval_reproduces_the_bench(nv_dir, capsys):
    bench, ckpt = _nv_run(nv_dir, 10)
    capsys.readouterr()
    out = _script("torch_nv_holdout_eval").main(PROTOCOL + ["--ckpt", ckpt])
    assert _last_json(capsys) == out
    assert set(out) == EVAL_KEYS | {"device", "card"}
    assert out["step"] == 20 and out["alive"] == bench["final_alive"]
    assert [r["pose"] for r in out["per_pose"]] == [0, 3]
    assert out["holdout_psnr_mean"] == pytest.approx(bench["final_holdout_psnr"],
                                                     abs=1e-6)
    assert out["holdout_ssim_mean"] == pytest.approx(bench["final_holdout_ssim"],
                                                     abs=1e-6)


def test_make_poses_match_the_jax_script():
    from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_args

    from openglgaussiansplattingrenderer_tpu_torch.render import camera_args

    want = _script("novel_view_bench").make_poses(72, 512, 512)
    got = _script("torch_novel_view_bench").make_poses(72, 512, 512)
    assert len(got) == len(want) == 72
    for g, w in zip(got, want):
        ga, wa = camera_args(g), jax_args(w)
        for k in wa:
            np.testing.assert_allclose(ga[k], np.asarray(wa[k]), atol=1e-6, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("cap", [2000, 100_000])
def test_sfm_init_matches_the_jax_package(cap):
    gt = jax_ply.make_clustered_scene(max(cap, 2000) // 2 + 1000, seed=3, extent=2.0)
    got = _script("torch_train_bench").sfm_init(gt["means"], cap)
    # the JAX scripts' lines (train_bench.py:90-96, novel_view_bench.py:137-143)
    rng = np.random.default_rng(0)
    n0 = max(cap // 8, 1000)
    idx = rng.choice(len(gt["means"]), n0, replace=False)
    pts = np.asarray(gt["means"])[idx] + rng.normal(0, 0.02, (n0, 3))
    want = jax_init_params(pts.astype(np.float32),
                           np.full((n0, 3), 128.0, np.float32), opacity=0.1)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_training_cfg(gt_params, cam, w, h, cap):
    """The render config the JAX scripts build (train_bench.py:66-79)."""
    R = importlib.import_module("openglgaussiansplattingrenderer_tpu.render")
    base = JaxConfig.for_resolution(w, h, tile_px=32, use_pallas=True, chunk=128)
    a = R.camera_args(cam)
    cfg = R.autotune_capacity(gt_params, a["view"], a["vp"], a["focal_x"],
                              a["focal_y"], a["tan_fovx"], a["tan_fovy"], w, h, base,
                              margin=1.6)
    return dataclasses.replace(cfg, capacity_records=max(
        cfg.capacity_records, R.quantize_capacity(int(cap * 2.5))))


@pytest.mark.parametrize("bench", ["train", "novel_view"])
def test_first_gt_target_matches_jax_render(bench):
    from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
    from openglgaussiansplattingrenderer_tpu.render import render_stats

    tb = _script("torch_train_bench")
    w = h = 64
    cap = 2000
    gt = jax_ply.make_clustered_scene(200, seed=3, extent=2.0)
    if bench == "train":
        cam = tb.ring_cameras(3, w, h)[0]
        jcam = JaxCamera(0.0, 0.6, -3.5, width=w, height=h)   # train_bench.py:61-65
        jcam.rotate_right(0.0)
    else:
        cam = _script("torch_novel_view_bench").make_poses(6, w, h)[0]
        jcam = _script("novel_view_bench").make_poses(6, w, h)[0]
    gtp = tb.gt_params(gt, "cpu")
    cfg = tb.training_cfg(gtp, cam, w, h, cap)
    got = tb.render_view(gtp, cam, cfg, w, h).numpy()

    jparams = {k: jnp.asarray(v) for k, v in gt.items() if k != "sh_rest"}
    jcfg = _jax_training_cfg(jparams, jcam, w, h, cap)
    assert cfg.capacity_records == jcfg.capacity_records
    img, stats = render_stats(jparams, jcam, jcfg, w, h)
    assert int(stats["overflow"]) == 0
    want = np.asarray(img)[..., :3]
    assert want.max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_correlated_colors_match_the_jax_formula():
    gt = jax_ply.make_clustered_scene(500, seed=3, extent=2.0)
    got = _script("torch_novel_view_bench").correlated_colors(gt["means"])
    # novel_view_bench.py:101-110
    m = np.asarray(gt["means"])
    phase = [np.sin(1.3 * m[:, 0] + 0.7 * m[:, 1]),
             np.sin(0.9 * m[:, 1] - 1.1 * m[:, 2] + 2.0),
             np.sin(1.7 * m[:, 2] + 0.5 * m[:, 0] + 4.0)]
    want = np.stack([(0.5 + 0.5 * p) * 255.0 for p in phase], axis=1).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
