"""The compositor's skip test on the CPU: ``patch_reach_plain``, the plain
PyTorch version of the test by which a warp of the CUDA compositor skips
the records that cannot reach its pixel patch. Tolerance: exact.

- every (record, patch) pair the test drops has alpha < alpha_min at every
  pixel of the patch by the compositor's own float32 formula, for random,
  degenerate, near-threshold and non-finite records; the rects are a warp's
  patch, a forward block's 16x16 pixels (the kernels stage only the records
  that reach the box around a block's live pixels) and a box left of a
  patch once pixels have saturated;
- with the patch equal to the whole tile the test takes the expansion's
  decision (``records.expand_plain``, and through it the JAX package's
  ``_expand_kernel`` in interpret mode);
- ``composite_plain`` and ``composite_bwd_plain`` with the per-patch mask
  are bit-equal to themselves without it;
- the patches cover every pixel of a tile once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu.camera import Camera
from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.io import ply as jax_ply
from openglgaussiansplattingrenderer_tpu.ops import fastpath as jax_fastpath
from openglgaussiansplattingrenderer_tpu.render import camera_args

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks

ALPHA_MIN, ALPHA_MAX, THRESH = 1 / 255, 0.99, 0.01
N = 4000


def _alpha(rec, fx, fy):
    """exp(power) * op of records (9, n) at tile-local pixels fx, fy (m,),
    float32, as the compositor computes it: (n, m)."""
    mxl, myl, ca, cb, cc, op = (rec[i][:, None] for i in range(6))
    s11 = torch.sqrt(torch.clamp_min(ca * 0.5, 0.0))
    s12 = (cb * 0.5) / torch.clamp_min(s11, 1e-20)
    s22 = torch.sqrt(torch.clamp_min(cc * 0.5 - s12 * s12, 0.0))
    u0 = -(s11 * mxl + s12 * myl)
    v0 = -(s22 * myl)
    u = s11 * fx + (s12 * fy + u0)
    v = s22 * fy + v0
    return torch.exp(-(u * u + v * v)) * op


def _random(rng, n, size):
    """Gaussians of a few pixels around and inside a size x size tile."""
    rec = np.zeros((9, n), np.float32)
    rec[0] = rng.uniform(-1.5 * size, 2.5 * size, n)
    rec[1] = rng.uniform(-1.5 * size, 2.5 * size, n)
    sx, sy = rng.uniform(0.3, 12.0, (2, n))
    rho = rng.uniform(-0.95, 0.95, n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    rec[2] = sy ** 2 / det
    rec[3] = -rho * sx * sy / det
    rec[4] = sx ** 2 / det
    rec[5] = rng.uniform(0.0, 1.0, n)
    return rec


def _records(kind, rng, size, rect):
    rec = _random(rng, N, size)
    if kind == "degenerate":
        which = rng.integers(0, 6, N)
        rec[2, which == 0] = 0.0                       # s11 clamped
        rec[2, which == 1] = -1.0
        rec[3, which == 2] *= 50.0                     # indefinite conic
        rec[4, which == 3] = 0.0
        rec[5, which == 4] = rng.choice([0.0, -0.5, 1e-35, ALPHA_MIN], (which == 4).sum())
        rec[2:5, which == 5] = 0.0
    elif kind == "near_threshold":
        # opacity set so that the largest alpha over the patch's pixels sits
        # within 1e-7 .. 1e-3 of alpha_min, on either side
        x0, y0, x1, y1 = rect
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        dx = xs.ravel()[None, :] - rec[0].astype(np.float64)[:, None]
        dy = ys.ravel()[None, :] - rec[1].astype(np.float64)[:, None]
        q = (rec[2][:, None] * dx * dx + 2 * rec[3][:, None] * dx * dy
             + rec[4][:, None] * dy * dy).min(axis=1)
        eps = rng.choice([-1, 1], N) * 10.0 ** rng.uniform(-7, -3, N)
        rec[5] = np.clip(ALPHA_MIN * (1 + eps) * np.exp(0.5 * np.minimum(q, 60.0)),
                         0, 1e30)
    elif kind == "non_finite":
        bad = rng.choice([np.nan, np.inf, -np.inf, 3e38, -3e38, 1e-38], N)
        row = rng.integers(0, 6, N)
        hit = rng.uniform(size=N) < 0.7
        rec[row[hit], np.nonzero(hit)[0]] = bad[hit]
    else:
        assert kind == "random"
    return torch.from_numpy(rec)


@pytest.mark.parametrize("size", [32, 16, 8])
@pytest.mark.parametrize("shape", [(8, 4), (16, 2), (32, 1), (16, 16), (5, 3)])
@pytest.mark.parametrize("kind", ["random", "degenerate", "near_threshold", "non_finite"])
def test_dropped_records_stay_below_alpha_min_in_the_patch(kind, shape, size):
    rng = np.random.default_rng(size * 100 + shape[0])
    w, h = min(shape[0], size), min(shape[1], size)
    dropped = blended = 0
    for x0, y0 in ((0, 0), (size - w, size - h), ((size - w) // 2, (size - h) // 2)):
        rect = (x0, y0, x0 + w - 1, y0 + h - 1)
        rec = _records(kind, rng, size, rect)
        reach = kc.patch_reach_plain(rec, 0, 0, rect, ALPHA_MIN)
        assert reach.dtype == torch.bool and reach.shape == (N,)
        xs, ys = np.meshgrid(np.arange(x0, x0 + w), np.arange(y0, y0 + h))
        alpha = _alpha(rec, torch.from_numpy(xs.ravel().astype(np.float32)),
                       torch.from_numpy(ys.ravel().astype(np.float32)))
        # NaN counts as blending: the kernel's fminf(alpha_max, NaN) is alpha_max
        blends = ((alpha >= ALPHA_MIN) | torch.isnan(alpha)).any(dim=1)
        assert not (blends & ~reach).any(), (
            f"{int((blends & ~reach).sum())} records dropped that blend")
        dropped += int((~reach).sum())
        blended += int(blends.sum())
    assert blended > 0
    if kind != "non_finite" or size > 8:
        assert dropped > 0                              # the test does skip


def _frame(seed, n, w, h):
    scene = jax_ply.make_synthetic_scene(n, seed=seed, extent=2.0)
    scene = {k: v for k, v in scene.items() if k != "sh_rest"}
    a = camera_args(Camera(0.0, 0.0, -6.0, width=w, height=h))
    jargs = ({k: jnp.asarray(v) for k, v in scene.items()},
             jnp.asarray(a["view"]), jnp.asarray(a["vp"]), a["focal_x"],
             a["focal_y"], a["tan_fovx"], a["tan_fovy"], w, h)
    targs = (params_from_numpy(scene, "cpu"), torch.from_numpy(a["view"]),
             torch.from_numpy(a["vp"]), a["focal_x"], a["focal_y"],
             a["tan_fovx"], a["tan_fovy"], w, h)
    return jargs, targs


CFG = dict(max_per_tile=1024, chunk=64, dup_capacity_factor=24.0)


@pytest.mark.parametrize("seed,n,w,h", [(3, 150, 128, 128), (9, 400, 128, 64)])
def test_whole_tile_patch_takes_the_expansion_decision(seed, n, w, h):
    jargs, targs = _frame(seed, n, w, h)
    cfg = RenderConfig(**CFG)
    table, prep = fastpath.splat_table(*targs, cfg)
    cum = ks.cumsum(prep["counts"])
    kw = fastpath.expand_kwargs(n, w, h, cfg)
    fields, tile, _ = kr.expand_plain(*table, cum, **kw)
    # every record's candidate tile: the expansion with a cull that keeps all
    _, cand, _ = kr.expand_plain(*table, cum, **dict(kw, alpha_min=1e-30))
    total = min(int(cum[-1]), kw["capacity"])
    fields, tile, cand = fields[:, :total], tile[:total], cand[:total]
    assert (cand < cfg.num_tiles).all()
    ox, oy = kc.tile_origins(cand, kw["pw"], kw["ph"], cfg.grid_x)
    reach = kc.patch_reach_plain(fields, ox, oy, (0, 0, kw["pw"] - 1, kw["ph"] - 1),
                                 kw["alpha_min"])
    kept = tile < cfg.num_tiles
    assert kept.any() and (~kept).any()
    assert torch.equal(reach, kept)
    # and the JAX expansion kernel's, in interpret mode
    _, rec_sm, _ = jax_fastpath.expand_depth_records(
        *jargs, JaxConfig(**CFG), stop_after="expand")
    jax_kept = np.asarray(rec_sm)[9, :total].astype(np.int32) < cfg.num_tiles
    np.testing.assert_array_equal(reach.numpy(), jax_kept)


def _scene(seed, tiles, per_tile, pw, ph):
    """Sorted records over a row of tiles, as the frame would bin them."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, per_tile, tiles)
    counts[tiles // 2] = 0
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n = int(bounds[-1])
    tile = np.repeat(np.arange(tiles), counts)
    rec = np.zeros((9, n + 5), np.float32)
    rec[0, :n] = tile * pw + rng.uniform(-3, pw + 3, n)
    rec[1, :n] = rng.uniform(-3, ph + 3, n)
    s = rng.uniform(0.02, 0.6, n)
    rec[2, :n], rec[4, :n] = s, s * rng.uniform(0.5, 1.5, n)
    rec[3, :n] = rng.uniform(-0.3, 0.3, n) * np.sqrt(rec[2, :n] * rec[4, :n])
    rec[5, :n] = rng.uniform(0.0, 0.99, n)
    rec[6:9, :n] = rng.uniform(0, 255, (3, n))
    ox = (np.arange(tiles) * pw).astype(np.int32)
    return (torch.from_numpy(rec), torch.from_numpy(bounds), torch.from_numpy(ox),
            torch.zeros(tiles, dtype=torch.int32))


@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("seed,pw,ph,chunk", [(1, 32, 32, 64), (2, 16, 16, 32),
                                              (3, 10, 7, 16)])
def test_patch_cull_changes_no_bit_of_the_plain_compositor(seed, pw, ph, chunk, which):
    rec, bounds, ox, oy = _scene(seed, 5, 300, pw, ph)
    kw = dict(pw=pw, ph=ph, chunk=chunk, alpha_min=ALPHA_MIN, alpha_max=ALPHA_MAX,
              thresh=THRESH)
    pairs = {}
    out = kc.composite_plain(rec, bounds, ox, oy, **kw, pair_counts=pairs)
    assert int(pairs["blended"]) < int(pairs["visited"])
    assert (out[..., 3] <= THRESH).any() and (out[..., 3] > 0.5).any()
    # the mask is not trivially true
    rects, of_pixel = kc.patch_rects(pw, ph)
    n = int(bounds[-1])
    tile = torch.repeat_interleave(torch.arange(5), (bounds[1:] - bounds[:-1]).long())
    reach = kc.patch_reach_plain(rec[:, :n], ox[tile], oy[tile], rects[0], ALPHA_MIN)
    assert reach.any() and (~reach).any()
    if which == "forward":
        assert torch.equal(out, kc.composite_plain(rec, bounds, ox, oy, **kw,
                                                   patch_cull=True))
    else:
        g = torch.from_numpy(np.random.default_rng(seed).normal(
            size=tuple(out.shape)).astype(np.float32))
        want = kc.composite_bwd_plain(rec, bounds, ox, oy, out, g, **kw)
        assert want.abs().max() > 0
        assert torch.equal(want, kc.composite_bwd_plain(rec, bounds, ox, oy, out, g,
                                                        **kw, patch_cull=True))


@pytest.mark.parametrize("pw,ph", [(32, 32), (16, 16), (8, 8), (10, 7), (16, 32),
                                   (64, 32), (5, 5), (3, 9), (1, 40)])
def test_patches_cover_every_pixel_once(pw, ph):
    px, py = kc.patch_shape(pw)
    assert px * py == 32 and px <= 8 and (px >= pw or px == 8)
    rects, of_pixel = kc.patch_rects(pw, ph)
    assert of_pixel.shape == (pw * ph,)
    seen = torch.zeros(pw * ph, dtype=torch.int64)
    for i, (x0, y0, x1, y1) in enumerate(rects):
        assert 0 <= x0 <= x1 < pw and 0 <= y0 <= y1 < ph
        assert x1 - x0 < px and y1 - y0 < py
        ys, xs = torch.meshgrid(torch.arange(y0, y1 + 1), torch.arange(x0, x1 + 1),
                                indexing="ij")
        pix = (ys * pw + xs).ravel()
        assert (of_pixel[pix] == i).all()
        seen[pix] += 1
    assert (seen == 1).all()
