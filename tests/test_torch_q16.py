"""The port's q16 inference precision mode on the CPU against the JAX
package's.

- the five packed words and the nine unpacked fields: bit-equal to
  ``_q16_pack`` / ``_q16_unpack`` (same float32 expression order, round half
  to even, float16 casts to nearest even), means off the range, conics over
  the float16 range and opacities outside [0, 1] included;
- ``sort_records_q16``: keys and fields bit-equal to the JAX function's;
- a q16 frame against the JAX q16 frame within 1e-4 (the ARCHITECTURE.md
  image contract; the two compositors sum a chunk's colour products in
  different orders) with equal stats;
- the q16 frame against the f32 frame on the scene of ``tests/test_q16.py``:
  below 2e-3, that test's budget, and above 0;
- differentiating a q16 frame raises, and the options that do not compose
  raise the JAX package's ``ValueError``s.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera as JaxCamera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops.pallas import records as jax_records
from openglgaussiansplattingrenderer_tpu.render import camera_args as jax_camera_args
from openglgaussiansplattingrenderer_tpu.render import render_arrays as jax_render

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.io import ply as port_ply
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays
from openglgaussiansplattingrenderer_tpu_torch.splats import inference_config

Q16 = dict(depth_key="packed", sort_payload="q16")


def _fields(n, wp, hp, seed=0):
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-1.2 * wp, 2.2 * wp, n)
    my = rng.uniform(-1.2 * hp, 2.2 * hp, n)
    conic = [rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-9, 6, n) for _ in range(3)]
    op = rng.uniform(-0.1, 1.1, n)
    col = [rng.uniform(0, 255, n) for _ in range(3)]
    return np.stack([mx, my, *conic, op, *col]).astype(np.float32)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


@pytest.mark.parametrize("wp,hp", [(1024, 512), (64, 64), (1920, 1088)])
def test_q16_words_and_fields_bit_equal_to_jax(wp, hp):
    f = _fields(4096, wp, hp, seed=wp)
    want_w = jax_records._q16_pack(tuple(jnp.asarray(r) for r in f), wp, hp)
    got_w = kr.q16_pack(torch.from_numpy(f), wp, hp)
    assert got_w.shape == (5, 4096) and got_w.dtype == torch.int32
    for a, b in zip(got_w, want_w):
        np.testing.assert_array_equal(_bits(a.numpy()), np.asarray(b))
    want_f = jax_records._q16_unpack(want_w, wp, hp)
    got_f = kr.q16_unpack(got_w, wp, hp)
    assert got_f.shape == (9, 4096) and got_f.dtype == torch.float32
    for a, b in zip(got_f, want_f):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    # the top bit of a word is in use: the int32 that holds it goes negative
    assert bool((got_w < 0).any())


def test_sort_records_q16_matches_jax():
    rng = np.random.default_rng(1)
    n = 512
    key = rng.integers(0, 50, n).astype(np.uint32)
    f = rng.uniform(0, 1, (9, n)).astype(np.float32)
    want_k, want_f = jax_records.sort_records_q16(
        jnp.asarray(key), tuple(jnp.asarray(r) for r in f), 64, 64)
    got_k, got_f = kr.sort_records_q16(torch.from_numpy(key.astype(np.int64)),
                                       torch.from_numpy(f), 64, 64)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k).astype(np.int64))
    for a, b in zip(got_f, want_f):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    with pytest.raises(ValueError, match="exactly 9 fields"):
        kr.sort_records_q16(torch.zeros(4, dtype=torch.int64), torch.zeros((8, 4)),
                            64, 64)


def _frame_args(scene, z, w, h):
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    a = jax_camera_args(JaxCamera(0.0, 0.0, z, width=w, height=h))
    return scene, (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
                   a["tan_fovy"], w, h)


def test_q16_frame_matches_the_jax_q16_frame():
    scene, args = _frame_args(jax_ply.make_synthetic_scene(600, seed=11, extent=2.0),
                              -6.0, 64, 64)
    opts = dict(grid_x=2, grid_y=2, chunk=128, capacity_records=2048, **Q16)
    img_j, st_j = jax_render({k: jnp.asarray(v) for k, v in scene.items()},
                             jnp.asarray(args[0]), jnp.asarray(args[1]), *args[2:],
                             JaxConfig(**opts))
    with torch.no_grad():
        img_t, st_t = render_arrays(params_from_numpy(scene, "cpu"), *args,
                                    port.RenderConfig(**opts))
    assert float(np.asarray(img_j)[..., 3].max()) > 0.5
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    assert set(st_t) == set(st_j)
    for k in st_j:
        assert st_t[k].item() == np.asarray(st_j[k]).item(), k
    assert st_t["overflow"].item() == 0


def test_q16_image_inside_reference_tolerance():
    # the scene and configuration of tests/test_q16.py
    scene, args = _frame_args(port_ply.make_synthetic_scene(512, seed=7, extent=1.5),
                              -4.0, 64, 64)
    f32 = port.RenderConfig(chunk=32, dup_capacity_factor=8.0, depth_key="packed")
    params = params_from_numpy(scene, "cpu")
    with torch.no_grad():
        img_f, st_f = render_arrays(params, *args, f32)
        img_q, st_q = render_arrays(params, *args, inference_config(f32))
    assert st_f["overflow"].item() == 0
    assert st_q["num_records"].item() == st_f["num_records"].item()
    err = float((img_q[..., :3] - img_f[..., :3]).abs().max())
    assert 0.0 < err < 2e-3, f"q16 image error {err} breaches the budget"
    assert float(img_f[..., :3].max()) > 0.05, "scene rendered empty"


def test_q16_backward_raises_and_bad_combinations_are_refused():
    scene, args = _frame_args(port_ply.make_synthetic_scene(64, seed=3, extent=1.5),
                              -4.0, 64, 64)
    cfg = port.RenderConfig(chunk=32, dup_capacity_factor=8.0, **Q16)
    p = {k: v.requires_grad_(True)
         for k, v in params_from_numpy(scene, "cpu").items()}
    img, _ = render_arrays(p, *args, cfg)
    assert img.requires_grad                  # the guard is in the graph
    with pytest.raises(NotImplementedError, match="inference-only"):
        torch.autograd.grad(img[..., :3].mean(), list(p.values()))
    with torch.no_grad():
        for bad in (dict(depth_key="pair"), dict(hoist_depth_sort=True)):
            with pytest.raises(ValueError, match="q16"):
                render_arrays(p, *args, port.RenderConfig(
                    chunk=32, dup_capacity_factor=8.0, **{**Q16, **bad}))
    with pytest.raises(ValueError, match="q16"):
        port.RenderConfig(sort_payload="q16", record_sort="radix")
    with pytest.raises(ValueError, match="sort_payload"):
        port.RenderConfig(sort_payload="bf16")


def test_splats_inference_mode(tmp_path):
    scene = port_ply.make_synthetic_scene(150, seed=3, extent=2.0)
    path = str(tmp_path / "scene.ply")
    port_ply.save_ply(path, scene["means"], scene["quats"], scene["scales"],
                      scene["opacities"], scene["colors"])
    cfg = port.RenderConfig(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)
    cam = port.Camera(0.0, 0.0, -6.0, width=128, height=128)
    exact = port.Splats(path, 128, 128, cfg, device="cpu")
    fast = port.Splats(path, 128, 128, cfg, device="cpu", inference=True)
    assert (fast.cfg.sort_payload, fast.cfg.depth_key) == ("q16", "packed")
    assert fast.cfg == inference_config(cfg) and exact.cfg == cfg
    err = np.abs(fast.render_camera(cam) - exact.render_camera(cam)).max()
    assert 0.0 < err < 2e-3
    assert fast.last_stats["overflow"] == 0
    # the facade runs on the card unless told otherwise
    assert inspect.signature(port.Splats).parameters["device"].default == "cuda"
