"""The packed depth key where near-equal depths tie, on the CPU: a scene of
overlapping splats whose depths step by about a float32 ulp of the
normalised depth, so several distinct depths share one 22-bit packed key
and the packed frame (ties in splat order) differs from the exact pair
frame (float depth order).

Held: the port's packed frame and its pair frame each within 1e-4 (the
image contract) of the JAX package's, with equal stats (the JAX fast path
in Pallas interpret mode, jitted); the packed frame differs from the pair
frame by more than 1e-3 (the ties are real); the float64 replay of
``scripts/torch_gate_divergence.py --frame packed`` explains every pixel
above 1e-3 with reordered tied records the pixel blends; and its tie
finder on a hand-made tile.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.render import render_arrays as jax_render

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args, render_arrays
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_gate_divergence.py"
_SPEC = importlib.util.spec_from_file_location("torch_gate_divergence", _PATH)
gd = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(gd)

W = H = 64
OPTS = dict(grid_x=2, grid_y=2, chunk=32, dup_capacity_factor=8.0)


def _tie_scene(n=40, seed=3):
    """n overlapping splats at one screen region, each 1e-5 farther than the
    last: about one float32 ulp of the normalised depth a step, some 3.4
    steps a packed-key quantum."""
    rng = np.random.default_rng(seed)
    means = np.zeros((n, 3), np.float32)
    means[:, :2] = rng.uniform(-0.4, 0.4, (n, 2))
    means[:, 2] = (np.arange(n) * 1e-5).astype(np.float32)
    return {"means": means, "scales": np.full((n, 3), 0.25, np.float32),
            "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
            "opacities": rng.uniform(0.3, 0.8, n).astype(np.float32),
            "colors": rng.uniform(0, 255, (n, 3)).astype(np.float32)}


def _args():
    a = camera_args(port.Camera(0.0, 0.0, -4.0, width=W, height=H))
    return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"],
            W, H)


@functools.lru_cache(maxsize=None)
def _jax_frame(depth_key):
    args = _args()
    cfg = JaxConfig(depth_key=depth_key, **OPTS)

    @jax.jit
    def f(p, view, vp):
        return jax_render(p, view, vp, *args[2:], cfg)

    img, stats = f({k: jnp.asarray(v) for k, v in _tie_scene().items()},
                   jnp.asarray(args[0]), jnp.asarray(args[1]))
    return np.asarray(img), {k: np.asarray(v).item() for k, v in stats.items()}


def _port_frame(depth_key):
    with torch.no_grad():
        img, stats = render_arrays(params_from_numpy(_tie_scene(), "cpu"), *_args(),
                                   port.RenderConfig(depth_key=depth_key, **OPTS))
    return img, {k: v.item() for k, v in stats.items()}


def test_packed_frame_with_ties_matches_jax():
    frames = {}
    for key in ("packed", "pair"):
        img, stats = _port_frame(key)
        want, want_stats = _jax_frame(key)
        assert stats["overflow"] == 0
        np.testing.assert_allclose(img.numpy(), want, atol=1e-4, err_msg=key)
        for k, v in want_stats.items():
            assert stats[k] == pytest.approx(v, abs=1e-6), (key, k)
        frames[key] = img
    assert float((frames["packed"] - frames["pair"]).abs().max()) > 1e-3, (
        "the scene has no tie that moves a pixel")


def test_replay_names_a_tie_behind_every_packed_pixel():
    params = params_from_numpy(_tie_scene(), "cpu")
    cfg = port.RenderConfig(depth_key="packed", **OPTS)
    img_packed, _ = _port_frame("packed")
    img_pair, _ = _port_frame("pair")
    max_diff, bad = gd.bad_pixels(img_packed, img_pair)
    assert len(bad) > 10
    findings = gd.attribute_ties(
        gd.TiedStreams(params, _args(), dataclasses.replace(cfg, depth_key="pair")), bad, cfg)
    assert all(f["explained"] and f["tied_records"] for f in findings)
    worst = max(findings, key=lambda f: f["diff"])
    assert worst["diff"] == pytest.approx(max_diff)
    assert abs(worst["replayed_diff"] - worst["diff"]) < 1e-4


def test_reordered_ties_names_only_records_that_move():
    # keys in packed order; the pair order puts record 2 before record 1
    # (tied on key 7), and keeps the tie on key 9 in order
    keys = np.array([5, 7, 7, 8, 9, 9])
    pair_pos = np.array([0, 2, 1, 3, 4, 5])
    assert gd.reordered_ties(keys, pair_pos).tolist() == [1, 2]
    assert gd.reordered_ties(np.array([1, 2, 3]), np.array([0, 1, 2])).tolist() == []
