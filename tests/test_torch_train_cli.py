"""The port's training CLI (``scripts/torch_train_cli.py``) in-process on
the CPU, and the bf16 backward-cotangent mode of the record sort
(``ops/kernels/records.BWD_COT_PACK``) against the JAX package's.

Tolerances: a resumed CLI run writes the uninterrupted run's PLY byte for
byte; the bf16 mode's field cotangents equal the JAX package's in that
mode (within 1e-6 relative: the same bfloat16 rounding of the same
cotangents), stay within 2^-8 of the float32 ones element for element,
and keep every zero; the default mode is the plain scatter, bit for bit;
a frame's gradients in the bf16 mode within 2.2e-2 of each tensor's
largest float32 gradient (the finite-difference gate the JAX package's
records.py holds the mode to; the segment sum of rounded cotangents that
cancel loses more than 2^-8 of the result).
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops.pallas import records as rk

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.io import colmap as cm
from openglgaussiansplattingrenderer_tpu_torch.io import dataset as ds
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.io.png import save_png
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent


def _cli():
    spec = importlib.util.spec_from_file_location(
        "torch_train_cli", REPO / "scripts" / "torch_train_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _target_ply(tmp_path, n=20):
    s = jax_ply.make_synthetic_scene(n, seed=9, extent=1.2)
    s["opacities"] = np.clip(s["opacities"], 0.5, 0.9)
    path = str(tmp_path / "target.ply")
    ply_io.save_ply(path, s["means"], s["quats"], s["scales"], s["opacities"],
                    s["colors"])
    return path


def _outs(tmp_path, tag):
    return [str(tmp_path / f"{tag}.ply"), str(tmp_path / f"{tag}.png"),
            str(tmp_path / f"{tag}.json")]


def _argv(scene, outs, *extra):
    return [scene, "-o", outs[0], "--out-png", outs[1], "--history", outs[2],
            "--device", "cpu", "--width", "64", "--height", "64", "--log-every", "1",
            *extra]


DENSIFY = ["--views", "2", "--orbit-radius", "4.0", "--init-count", "10",
           "--densify", "--capacity", "24", "--densify-start", "1",
           "--densify-interval", "2", "--grad-threshold", "1e-6", "--bf16-grads"]


def test_cli_densify_run_and_resume(tmp_path, capsys):
    cli = _cli()
    scene = _target_ply(tmp_path)
    full = _outs(tmp_path, "full")
    assert cli.main(_argv(scene, full, "--steps", "4", *DENSIFY)) == 0
    assert kr.BWD_COT_PACK == "f32", "the CLI left the bf16 mode on"
    for f in full:
        assert os.path.exists(f), f
    hist = json.load(open(full[2]))
    assert [h["step"] for h in hist["history"]] == [0, 1, 2, 3]
    assert np.isfinite(hist["final_psnr_view0"])
    assert hist["splats"] > 10, "densification never grew the set"
    assert ply_io.load_splats(full[0])["means"].shape[0] == hist["splats"]
    assert "step 2: densify" in capsys.readouterr().out

    # kill after step 2 (before the densify), then resume to the end
    ckpt = str(tmp_path / "mid.ckpt.npz")
    cut = _outs(tmp_path, "cut")
    assert cli.main(_argv(scene, cut, "--steps", "2", "--save-every", "2",
                          "--ckpt", ckpt, *DENSIFY)) == 0
    resumed = _outs(tmp_path, "resumed")
    assert cli.main(_argv(scene, resumed, "--steps", "4", "--resume", ckpt,
                          *DENSIFY)) == 0
    assert [h["step"] for h in json.load(open(resumed[2]))["history"]] == [2, 3]
    assert Path(resumed[0]).read_bytes() == Path(full[0]).read_bytes()


PARALLEL = ["--views", "2", "--orbit-radius", "4.0", "--init-count", "10", "--densify",
            "--capacity", "24", "--densify-start", "1", "--densify-interval", "2",
            "--grad-threshold", "1e-6", "--steps", "4"]


@pytest.mark.parametrize("flag", [["--data-parallel", "2"], ["--mesh2d", "2x2"]])
def test_cli_parallel_routes_write_the_direct_fit(tmp_path, flag):
    """``--data-parallel 2`` and ``--mesh2d 2x2`` on ``--device cpu`` train
    through ``fit_scene_dp`` / ``fit_scene_2d`` on repeated CPU devices:
    each writes its three files, and its PLY is byte for byte the PLY of
    the direct call on the same scene, views and start."""
    from openglgaussiansplattingrenderer_tpu_torch.parallel import data_parallel as dp
    from openglgaussiansplattingrenderer_tpu_torch.parallel import mesh2d
    from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import TrainConfig

    cli = _cli()
    scene = _target_ply(tmp_path)
    outs = _outs(tmp_path, "par")
    argv = _argv(scene, outs, *PARALLEL, *flag)
    assert cli.main(argv) == 0
    for f in outs:
        assert os.path.exists(f), f
    hist = json.load(open(outs[2]))
    assert [h["step"] for h in hist["history"]] == [0, 1, 2, 3]
    assert np.isfinite(hist["final_psnr_view0"])

    args = cli.parse_args(argv)
    cfg = port.RenderConfig.for_resolution(64, 64, tile_px=32, chunk=256,
                                           dup_capacity_factor=8.0)
    cams, targets, start, extent = cli.load_scene(args, cfg, torch.device("cpu"),
                                                  np.random.default_rng(0))
    dc = dn.DensifyConfig(capacity=24, grad_threshold=1e-6, scene_extent=extent,
                          interval=2, start_step=1, stop_step=3)
    kw = dict(width=64, height=64, dc=dc, seed=0, log_every=1, verbose=False)
    tc = TrainConfig(steps=4, lambda_dssim=0.2)
    if flag[0] == "--mesh2d":
        fitted, alive, _ = mesh2d.fit_scene_2d(
            start, targets, cams, cfg, tc, mesh=mesh2d.make_mesh2d(2, 2, devices=["cpu"] * 4),
            **kw)
    else:
        fitted, alive, _ = dp.fit_scene_dp(start, targets, cams, cfg, tc,
                                           mesh=dp.make_mesh(devices=["cpu"] * 2), **kw)
    direct = dn.compact_params(fitted, alive)
    path = str(tmp_path / "direct.ply")
    ply_io.save_ply(path, direct["means"], direct["quats"], direct["scales"],
                    direct["opacities"], direct["colors"])
    assert Path(path).read_bytes() == Path(outs[0]).read_bytes()
    assert hist["splats"] == direct["means"].shape[0]


@pytest.mark.parametrize("flags,fatal", [
    (["--data-parallel", "2", "--mesh2d", "2x2"], "mutually exclusive"),
    (["--mesh2d", "2by2"], "wants DVxDS with positive dims"),
    (["--mesh2d", "64x64", "--device", "cuda"], "needs 4096 CUDA devices"),
])
def test_cli_refuses_what_the_parallel_flags_cannot_run(tmp_path, capsys, flags, fatal):
    outs = _outs(tmp_path, "dp")
    assert _cli().main(_argv(str(tmp_path / "none.ply"), outs, *flags)) == 1
    err = capsys.readouterr().err
    assert "FATAL" in err and fatal in err
    assert not any(os.path.exists(f) for f in outs)


def _render_views(params, c2ws, w, h, fl):
    cfg = port.RenderConfig.for_resolution(w, h, tile_px=32, use_pallas=False,
                                           max_per_tile=256, chunk=64,
                                           dup_capacity_factor=32.0)
    out = []
    for c2w in c2ws:
        b = ds.bundle_from_c2w(c2w, w, h, fl_x=fl, fl_y=fl)
        img, _ = render_arrays(params, b["view"], b["vp"], b["focal_x"], b["focal_y"],
                               b["tan_fovx"], b["tan_fovy"], w, h, cfg)
        arr = img[..., :3].numpy()
        assert arr.max() > 0.02, "the test camera does not see the scene"
        out.append((b, arr))
    return out


def _c2w(pos, yaw_deg):
    a = np.deg2rad(yaw_deg)
    m = np.eye(4)
    m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    m[:3, 3] = pos
    return m


@pytest.mark.parametrize("route", ["colmap", "transforms"])
def test_cli_posed_image_routes(tmp_path, capsys, route):
    """The COLMAP workspace route (SfM point init) and the transforms.json
    route (random init) train and write their three files."""
    w = h = 64
    scene = jax_ply.make_synthetic_scene(40, seed=6, extent=1.0)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    c2ws = [_c2w([0, 0, 4.0], 0.0), _c2w([1.2, 0, 3.8], 17.0)]
    views = _render_views(convert.params_from_numpy(scene, "cpu"), c2ws, w, h, 70.0)
    names = [f"v{i}.png" for i in range(2)]
    if route == "colmap":
        root = tmp_path / "capture"
        sparse, imgdir = root / "sparse" / "0", root / "images"
        sparse.mkdir(parents=True)
        imgdir.mkdir()
        cm.write_cameras_bin(str(sparse / "cameras.bin"), {1: {
            "model": "PINHOLE", "width": w, "height": h,
            "params": np.array([70.0, 70.0, w / 2.0, h / 2.0])}})
        poses = []
        for m in c2ws:
            w2c = np.linalg.inv(m @ np.diag([1.0, -1.0, -1.0, 1.0]))
            poses.append((cm.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3]))
        cm.write_images_bin(str(sparse / "images.bin"), [
            {"image_id": i + 1, "qvec": q, "tvec": t, "camera_id": 1, "name": names[i]}
            for i, (q, t) in enumerate(poses)])
        cm.write_points3d_bin(str(sparse / "points3D.bin"), scene["means"],
                              np.clip(scene["colors"], 0, 255).astype(np.uint8))
        arg = str(root)
    else:
        imgdir = tmp_path
        ds.save_transforms(str(tmp_path / "transforms.json"), [b for b, _ in views], names)
        arg = str(tmp_path / "transforms.json")
    for name, (_, arr) in zip(names, views):
        save_png(str(imgdir / name), arr)
    outs = _outs(tmp_path, route)
    assert _cli().main(_argv(arg, outs, "--steps", "3", "--init-count", "64")) == 0
    err = capsys.readouterr().err
    assert ("COLMAP: 2 posed images, 40 SfM" in err if route == "colmap"
            else "dataset: 2 posed images, init 64" in err), err
    hist = json.load(open(outs[2]))
    assert np.isfinite(hist["final_psnr_view0"]) and len(hist["history"]) == 3
    assert all(os.path.exists(f) for f in outs)


# ---- the bf16 backward-cotangent mode -------------------------------------

def _sort_case(n=4096, f=9, seed=3):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 512, n).astype(np.int32)
    fields = rng.standard_normal((f, n)).astype(np.float32)
    # the loss's cotangents, with exact zeros, over a wide range of scales
    w = (rng.standard_normal((f, n)) * np.exp(rng.uniform(-20, 20, (f, n)))
         * (rng.uniform(0, 1, (f, n)) > 0.2)).astype(np.float32)
    return key, fields, w


def _port_grads(key, fields, w, **kw):
    x = torch.from_numpy(fields).requires_grad_(True)
    _, _, sf = kr.sort_with_payload(torch.from_numpy(key), x, **kw)
    (g,) = torch.autograd.grad((sf * torch.from_numpy(w)).sum(), x)
    return g.numpy()


def _jax_grads(key, fields, w):
    def loss(fs):
        _, _, sf = rk.sort_with_payload(jnp.asarray(key), fs)
        return sum(jnp.sum(a * jnp.asarray(b)) for a, b in zip(sf, w))
    return np.stack([np.asarray(g) for g in
                     jax.grad(loss)(tuple(jnp.asarray(r) for r in fields))])


@pytest.mark.parametrize("f", [9, 4])
def test_bf16_cotangents_match_jax(monkeypatch, f):
    key, fields, w = _sort_case(f=f)
    g32 = _port_grads(key, fields, w)
    si = np.argsort(key, kind="stable")
    plain = np.empty_like(w)
    plain[:, si] = w
    np.testing.assert_array_equal(g32, plain)          # the default: f32, exact
    monkeypatch.setattr(kr, "BWD_COT_PACK", "bf16")
    monkeypatch.setattr(rk, "BWD_COT_PACK", "bf16")
    g16 = _port_grads(key, fields, w)
    want = _jax_grads(key, fields, w)
    assert np.abs(g16 - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_array_equal(g16, want)
    paired = f // 2 * 2
    assert not np.array_equal(g16[:paired], g32[:paired])
    np.testing.assert_array_equal(g16[paired:], g32[paired:])   # odd last row f32
    assert (np.abs(g16 - g32) <= 2.0 ** -8 * np.abs(g32)).all()
    np.testing.assert_array_equal(g16 == 0, g32 == 0)
    # paired_rows rounds every row the caller names (the hoisted sort's 9)
    g_all = _port_grads(key, fields, w, paired_rows=f)
    np.testing.assert_array_equal(
        g_all, torch.from_numpy(g32).to(torch.bfloat16).float().numpy())


def test_bf16_frame_gradients_stay_close(monkeypatch):
    scene = jax_ply.make_synthetic_scene(40, seed=2, extent=1.2)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    a = camera_args(port.Camera(0.0, 0.0, -4.0, width=64, height=64))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], 64, 64)

    def grads(**opts):
        p = {k: v.requires_grad_(True)
             for k, v in convert.params_from_numpy(scene, "cpu").items()}
        img, _ = render_arrays(p, *args, port.RenderConfig(chunk=64, **opts))
        loss = ((img[..., :3] - 0.3) ** 2).mean()
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    for opts in ({}, {"hoist_depth_sort": True}):
        g32 = grads(**opts)
        monkeypatch.setattr(kr, "BWD_COT_PACK", "bf16")
        g16 = grads(**opts)
        monkeypatch.setattr(kr, "BWD_COT_PACK", "f32")
        assert any(not torch.equal(g16[k], g32[k]) for k in g32)
        for k in g32:
            scale = float(g32[k].abs().max())
            assert float((g16[k] - g32[k]).abs().max()) <= 2.2e-2 * scale, (opts, k)


def test_bf16_mode_is_read_from_the_environment_at_import():
    code = ("from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records; "
            "print(records.BWD_COT_PACK)")
    for env, want in (({"GS_BWD_SORT": "bf16"}, "bf16"), ({}, "f32")):
        e = {k: v for k, v in os.environ.items() if k != "GS_BWD_SORT"}
        e.update(env, PYTHONPATH=str(REPO))
        out = subprocess.run([sys.executable, "-c", code], env=e, cwd=str(REPO),
                             capture_output=True, text=True, timeout=120, check=True)
        assert out.stdout.strip() == want
