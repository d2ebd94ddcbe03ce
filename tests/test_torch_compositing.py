"""The port's oracle compositor (``ops/compositing.composite``) against the
reference's sequential blend and the JAX package's compositor.

Mirrors ``tests/test_compositing.py``: the parallel masked-cumsum
formulation reproduces draw.glsl's sequential front-to-back blend with the
0.99 early break (draw.glsl:109-134), on random, saturating and empty
tiles, here through the port's own ``composite_ranges``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.ops import compositing as jax_compositing

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import compositing
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _sequential(rec, starts, ends, pxs, pys, cfg):
    """draw.glsl:59-67,109-134 literally, per pixel, in float64: rgb
    (T, P, 3) and transmittance (T, P)."""
    t_n, p_n = pxs.shape
    rgb = np.zeros((t_n, p_n, 3))
    trans = np.ones((t_n, p_n))
    for t in range(t_n):
        for p in range(p_n):
            acc = 0.0
            for k in range(starts[t], ends[t]):
                dx = pxs[t, p] - rec["mean2d"][k, 0]
                dy = pys[t, p] - rec["mean2d"][k, 1]
                a, b, c = rec["conic"][k]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(cfg.alpha_max, np.exp(power) * rec["opacity"][k])
                if power > 0.0 or alpha < cfg.alpha_min:
                    continue
                blend = alpha * (1.0 - acc)
                rgb[t, p] += rec["color"][k] * blend
                acc += blend
                if acc >= cfg.saturation:
                    break
            trans[t, p] = 1.0 - acc
    return rgb, trans


def _random_records(rng, c, extent):
    rec = {
        "mean2d": rng.uniform(0, extent, (c, 2)),
        "conic": np.stack([rng.uniform(0.05, 0.5, c), rng.uniform(-0.02, 0.02, c),
                           rng.uniform(0.05, 0.5, c)], axis=1),
        "color": rng.uniform(0, 255, (c, 3)),
        "opacity": rng.uniform(0.0, 0.99, c),
    }
    rec["opacity"][rng.random(c) < 0.3] = 0.0          # masked records
    return {k: v.astype(np.float32) for k, v in rec.items()}


def _port_ranges(rec, starts, ends, pxs, pys, cfg):
    rgb, trans = compositing.composite_ranges(
        {k: torch.as_tensor(v) for k, v in rec.items()}, torch.as_tensor(starts),
        torch.as_tensor(ends), torch.as_tensor(pxs), torch.as_tensor(pys), cfg)
    return rgb.numpy(), trans.numpy()


@pytest.mark.parametrize("chunk", [8, 64])
def test_parallel_equals_sequential_random(chunk):
    rng = np.random.default_rng(1234)
    opts = dict(grid_x=2, grid_y=2, chunk=chunk, max_per_tile=64)
    cfg = RenderConfig(**opts)
    pxs, pys = (v.numpy() for v in compositing.tile_pixel_coords(8, 8, cfg, device="cpu"))
    rec = _random_records(rng, 120, 8.0)
    # tile 3 is empty; tile 1 starts past tile 0's records
    starts = np.array([0, 40, 90, 90], np.int32)
    ends = np.array([30, 90, 150 - 30, 90], np.int32)
    rgb, trans = _port_ranges(rec, starts, ends, pxs, pys, cfg)
    rgb_s, trans_s = _sequential(rec, starts, ends, pxs, pys, cfg)
    np.testing.assert_allclose(rgb, rgb_s, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(trans, trans_s, atol=1e-5)
    assert np.all(trans[3] == 1.0) and np.all(rgb[3] == 0.0)
    rgb_j, trans_j = jax_compositing.composite_ranges(
        {k: jnp.asarray(v) for k, v in rec.items()}, jnp.asarray(starts),
        jnp.asarray(ends), jnp.asarray(pxs), jnp.asarray(pys), JaxConfig(**opts))
    np.testing.assert_allclose(rgb, np.asarray(rgb_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(trans, np.asarray(trans_j), atol=1e-6)


def test_parallel_equals_sequential_saturating():
    """One pixel, records centred on it (alpha = opacity): the third record
    crosses 0.99 (transmittance 1, 0.1, 0.02, then 0.001) and the fourth
    and fifth contribute nothing. (0.9, 0.9, 0.9 would put the third
    record's transmittance on the threshold itself, where float32 and
    float64 round to different sides.)"""
    cfg = RenderConfig(grid_x=1, grid_y=1, chunk=2, max_per_tile=8)
    rec = {
        "mean2d": np.zeros((5, 2), np.float32),
        "conic": np.tile(np.array([1.0, 0.0, 1.0], np.float32), (5, 1)),
        "color": (np.eye(3)[[0, 1, 2, 0, 1]] * 100.0).astype(np.float32),
        "opacity": np.array([0.9, 0.8, 0.95, 0.5, 0.7], np.float32),
    }
    pxs = pys = np.zeros((1, 1), np.float32)
    starts, ends = np.array([0], np.int32), np.array([5], np.int32)
    rgb, trans = _port_ranges(rec, starts, ends, pxs, pys, cfg)
    rgb_s, trans_s = _sequential(rec, starts, ends, pxs, pys, cfg)
    np.testing.assert_allclose(rgb, rgb_s, rtol=1e-5)
    np.testing.assert_allclose(trans, trans_s, atol=1e-6)
    # acc after the third record is 1 - 0.1 * 0.2 * 0.05; only the first red
    # record reaches the red channel
    np.testing.assert_allclose(1.0 - trans[0, 0], 0.999, atol=1e-6)
    np.testing.assert_allclose(rgb[0, 0, 0], 90.0, rtol=1e-6)


def test_composite_empty_tiles():
    """No records: the background, with zero alpha."""
    cfg = RenderConfig(background=(0.25, 0.5, 0.75), max_per_tile=64, chunk=32)
    c = 64
    records = {"mean2d": torch.zeros((c, 2)), "conic": torch.zeros((c, 3)),
               "color": torch.zeros((c, 3)), "opacity": torch.zeros((c,))}
    bounds = torch.zeros(cfg.num_tiles + 1, dtype=torch.int32)
    img, aux = compositing.composite(records, bounds, 64, 64, cfg)
    assert img.shape == (64, 64, 4)
    np.testing.assert_allclose(img[..., 0].numpy(), 0.25, atol=1e-6)
    np.testing.assert_allclose(img[..., 2].numpy(), 0.75, atol=1e-6)
    np.testing.assert_allclose(img[..., 3].numpy(), 0.0, atol=1e-6)
    assert int(aux["dropped_by_cap"]) == 0


def test_dropped_by_cap_matches_jax():
    # records past ceil(max_per_tile / chunk) chunks are not composited and
    # are counted
    rng = np.random.default_rng(7)
    opts = dict(grid_x=2, grid_y=2, chunk=16, max_per_tile=40)
    rec = _random_records(rng, 200, 16.0)
    bounds = np.array([0, 20, 90, 110, 200], np.int32)
    img, aux = compositing.composite({k: torch.as_tensor(v) for k, v in rec.items()},
                                     torch.as_tensor(bounds), 16, 16,
                                     RenderConfig(**opts))
    img_j, aux_j = jax_compositing.composite({k: jnp.asarray(v) for k, v in rec.items()},
                                             jnp.asarray(bounds), 16, 16,
                                             JaxConfig(**opts))
    assert int(aux["dropped_by_cap"]) == int(aux_j["dropped_by_cap"]) == 22 + 42
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=1e-6)
    np.testing.assert_array_equal(compositing.tile_pixel_coords(
        16, 16, RenderConfig(**opts), device="cpu")[0].numpy(), np.asarray(
        jax_compositing.tile_pixel_coords(16, 16, JaxConfig(**opts))[0]))
