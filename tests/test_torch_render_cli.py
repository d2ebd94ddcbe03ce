"""The port's render CLI (``scripts/torch_render_cli.py``) in-process on the
CPU, route by route, against the JAX package's ``Splats`` and
``viewer/offline.py`` on the same PLY and pose.

Tolerances: every written PNG within one 8-bit level of the JAX frame
encoded the same way (frames within 1e-4 of each other can round to
neighbouring levels); stats printed with ``--stats`` equal to the JAX
frame's record count.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu import Splats as JaxSplats
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.io.png import to_uint8
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args
from openglgaussiansplattingrenderer_tpu.viewer import offline as joffline

from openglgaussiansplattingrenderer_tpu_torch.io.png import load_png
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
W = H = 64
POSE = ["--pos", "0", "0", "-4", "--rot", "0", "0", "0"]
# 16 px tiles: a 4x4 grid keeps the JAX side's interpret-mode kernels small
BASE = ["--width", str(W), "--height", str(H), "--tile-px", "16", "--chunk", "32",
        "--capacity-factor", "32", "--device", "cpu"]


def _cli():
    spec = importlib.util.spec_from_file_location(
        "torch_render_cli", REPO / "scripts" / "torch_render_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    s = jax_ply.make_synthetic_scene(40, seed=9, extent=1.5)
    p = str(tmp_path_factory.mktemp("cli") / "scene.ply")
    jax_ply.save_ply(p, s["means"], s["quats"], s["scales"], s["opacities"], s["colors"])
    return p


def _jax(scene, **opts):
    cfg = JaxConfig.for_resolution(W, H, tile_px=16, chunk=32,
                                   dup_capacity_factor=32.0, **opts)
    cam = JaxCamera(0.0, 0.0, -4.0, width=W, height=H)
    cam.set_rotation(0.0, 0.0, 0.0)
    return JaxSplats(scene, W, H, cfg=cfg), cam, cfg


def _u8(path):
    return np.round(load_png(path) * 255.0).astype(int)


def _close(path, want):
    got = _u8(path)
    want = to_uint8(np.asarray(want)).astype(int)[..., :got.shape[-1]]
    assert got.shape == want.shape
    assert got.max() > 20, "the frame shows nothing"
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("route,flags,opts", [
    ("default", [], {}),
    ("oracle", ["--no-pallas"], {"use_pallas": False}),
    ("q16", ["--q16"], {"sort_payload": "q16", "depth_key": "packed"}),
])
def test_frame_routes_match_jax(scene, tmp_path, capsys, route, flags, opts):
    out = str(tmp_path / f"{route}.png")
    assert _cli().main([scene, "-o", out, *POSE, *BASE, "--stats", *flags]) == 0
    text = capsys.readouterr().out
    assert "loaded 40 splats" in text and f"wrote {out}" in text
    splats, cam, _ = _jax(scene, **opts)
    want = splats.render_camera(cam)
    assert f"num_records: {int(splats.last_stats['num_records'])}" in text
    _close(out, want)


def test_golden_route_matches_jax(scene, tmp_path):
    out = str(tmp_path / "gold.png")
    assert _cli().main([scene, "-o", out, "--golden", *POSE, *BASE]) == 0
    splats, cam, _ = _jax(scene)
    a = jax_camera_args(cam)
    want = splats.cpu_render(a["view"], W, H, a["focal_x"], a["focal_y"],
                             a["tan_fovx"], a["tan_fovy"], a["vp"], save_path=None)
    _close(out, want)


def test_depth_route_matches_jax(scene, tmp_path):
    out = str(tmp_path / "depth.png")
    assert _cli().main([scene, "-o", out, "--depth", *POSE, *BASE]) == 0
    splats, cam, _ = _jax(scene)
    depth, alpha = (np.asarray(v) for v in splats.render_depth_camera(cam))
    covered = alpha > 1e-3
    lo, hi = depth[covered].min(), depth[covered].max()
    depth = np.where(covered, (depth - lo) / max(hi - lo, 1e-12), 0.0)
    _close(out, np.repeat(depth[..., None], 3, axis=-1))


def test_orbit_route_matches_jax(scene, tmp_path, capsys):
    out_dir = tmp_path / "frames"
    assert _cli().main([scene, "--orbit", "3", "--out-dir", str(out_dir),
                        "--orbit-radius", "4", *BASE]) == 0
    assert "orbit:" in capsys.readouterr().out
    files = sorted(p.name for p in out_dir.iterdir())
    assert files == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    splats, _, cfg = _jax(scene)
    cams = joffline.orbit_cameras((0.0, 0.0, 0.0), 4.0, 3, width=W, height=H)
    for i, cam in enumerate(cams):
        want = joffline.render_frame(splats.scene, cam, cfg)
        _close(str(out_dir / files[i]), np.asarray(want)[..., :3])


def test_cuda_default_refused_without_a_card(scene, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "none.png")
    argv = [scene, "-o", out, *POSE, "--width", str(W), "--height", str(H)]
    assert _cli().main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not Path(out).exists()
