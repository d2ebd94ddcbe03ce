"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere (the fixture
decides, at run time). They import nothing of JAX; on a machine with a
card run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

They cover what ``chip_smoke.py``'s flagship shapes do not: every
tile shape of the compositor (one to sixty-four pixel patches, ragged
edges), pixels past the tile, empty tiles first, last and in a row, one
tile of 200,000 records that never saturates, a tile that saturates inside
its first batch, records crowded on pixels that have saturated while others
stay alive, records centred on patch and tile borders, a gradient
buffer that was not zero, a batch above the default 48 KB of shared memory,
overflow in the
segment sum, run-to-run equality, training on the card, the record sort
stage (both keys, 512 and 2,040 tiles, ragged and one-record sizes, words
off the 16-byte grid, both cotangent modes, the frame's gradients against
the plain stage), the single-pass
prefix sum at tile edges, on unaligned views, on wrapping sums and 200
launches running, the onesweep radix sort's counts (views off the 16-byte
grid too) and scatter at ragged sizes, on sorted, reversed, constant and
one-key-a-digit inputs and both digit widths, whole sorts through an
unaligned key view, 200 sorts running and on two streams, the single-key
sort paths of the frame, the two probe kernels, and the expansion and the segment sum on the partition cases of
``test_torch_records_partition.py`` (runs of empty splats longer than
several blocks' share, a splat over three blocks, ``total == capacity``,
overflow, one splat, a capacity that is not a multiple of 4, inputs off the
16-byte grid); and the splat table's two kernels on splats placed behind
the camera, off-screen, past the fov clamp and at zero scale, at splat
counts that leave a warp or a block ragged, every SH degree and row
length, both covariance routes, with a shift and without. Frames with no
gradient: an eager frame and a training step make no synchronising call
(``torch.cuda.set_sync_debug_mode("error")``); the captured frame's
replays over an orbit are bit-equal to eager frames, image and stats, keep
no frame's tensors for the next, count the launches an eager frame counts,
and show an in-place edit of the parameters.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import record_sort as rs
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import table as kt
from openglgaussiansplattingrenderer_tpu_torch.ops.transforms import build_covariance
from openglgaussiansplattingrenderer_tpu_torch.probes import bucketer_probe, cache_key_probe
from openglgaussiansplattingrenderer_tpu_torch.render import (
    frame_graphs,
    render_arrays,
    render_stats,
)
from openglgaussiansplattingrenderer_tpu_torch.train import trainer
from test_torch_records_partition import CASES, GX, GY, PH, PW, partition_case, splat_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _records(seed, tiles, per_tile, pw, ph, device):
    """Sorted records over a row of tiles: random Gaussians around each tile."""
    g = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, per_tile, (tiles,), generator=g)
    counts[tiles // 2] = 0                                  # an empty tile
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)])
    n = int(bounds[-1])
    tile = torch.repeat_interleave(torch.arange(tiles), counts)
    rec = torch.zeros((9, n + 37))                          # columns no tile owns
    rec[0, :n] = tile * pw + torch.rand(n, generator=g) * pw
    rec[1, :n] = torch.rand(n, generator=g) * ph
    s = 0.02 + torch.rand(n, generator=g) * 0.2
    rec[2, :n], rec[4, :n] = s, s * (0.5 + torch.rand(n, generator=g))
    rec[3, :n] = (torch.rand(n, generator=g) - 0.5) * 0.02
    rec[5, :n] = 0.05 + torch.rand(n, generator=g) * 0.94
    rec[6:9, :n] = torch.rand((3, n), generator=g) * 255
    ox = (torch.arange(tiles) * pw).to(torch.int32)
    oy = torch.zeros(tiles, dtype=torch.int32)
    return tuple(t.to(device) for t in (rec, bounds.to(torch.int32), ox, oy))


@pytest.mark.parametrize("pw,ph,chunk", [
    (8, 8, 16), (10, 7, 64), (16, 32, 256), (32, 32, 256), (64, 32, 128),
    (32, 32, 1024), (5, 5, 32), (32, 32, 100)])
def test_compositor_kernels_match_plain(card, pw, ph, chunk):
    rec, bounds, ox, oy = _records(pw * ph + chunk, 9, 700, pw, ph, card)
    kw = dict(pw=pw, ph=ph, chunk=chunk, alpha_min=1 / 255, alpha_max=0.99,
              thresh=0.01)
    f0, b0 = kc.composite.launches, kc.composite_bwd.launches
    with torch.no_grad():
        got = kc.composite(rec, bounds, ox, oy, **kw)
        ref = kc.composite_plain(rec, bounds, ox, oy, **kw)
        assert float((got - ref).abs().max() / 255) <= 5e-3
        assert float((got[..., 3] <= 0.01).float().mean()) > 0   # saturation is hit
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(card)
        d_got = kc.composite_bwd(rec, bounds, ox, oy, got, g, **kw)
        d_ref = kc.composite_bwd_plain(rec, bounds, ox, oy, ref, g, **kw)
    torch.cuda.synchronize()
    assert (kc.composite.launches, kc.composite_bwd.launches) == (f0 + 1, b0 + 1)
    scale = d_ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    assert float(((d_got - d_ref).abs() / scale).max()) <= 5e-3
    assert not d_got[:, int(bounds[-1]):].any()
    # the same launch again gives the same bits: no atomics
    assert torch.equal(d_got, kc.composite_bwd(rec, bounds, ox, oy, got, g, **kw))


KW = dict(alpha_min=1 / 255, alpha_max=0.99, thresh=0.01)


def _dirty_allocator(like):
    """Leave NaNs in the block the next allocation of ``like``'s size gets:
    a kernel that counts on a cleared output shows."""
    junk = torch.full_like(like, float("nan"))
    del junk


def _compare_compositor(rec, bounds, ox, oy, **kw):
    """Both kernels against their plain versions (forward 5e-3 of the colour
    scale, backward 5e-3 of a row's largest gradient), the backward twice."""
    n = int(bounds[-1])
    with torch.no_grad():
        got = kc.composite(rec, bounds, ox, oy, **kw)
        ref = kc.composite_plain(rec, bounds, ox, oy, **kw)
        assert float((got - ref).abs().max() / 255) <= 5e-3
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(1)).to(
            rec.device)
        _dirty_allocator(rec)
        d_got = kc.composite_bwd(rec, bounds, ox, oy, got, g, **kw)
        d_ref = kc.composite_bwd_plain(rec, bounds, ox, oy, ref, g, **kw)
        assert bool(torch.isfinite(d_got).all())
        scale = d_ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        assert float(((d_got - d_ref).abs() / scale).max()) <= 5e-3
        assert not d_got[:, n:].any() and not d_got[:, :int(bounds[0])].any()
        _dirty_allocator(rec)
        assert torch.equal(d_got, kc.composite_bwd(rec, bounds, ox, oy, got, g, **kw))
    return got, d_got


def _one_tile(n, seed, sigma, opacity, card, pad=11):
    """n records scattered over one 32x32 tile: isotropic Gaussians."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((9, n + pad), np.float32)
    rec[0, :n], rec[1, :n] = rng.uniform(-2, 34, (2, n))
    s = rng.uniform(*sigma, n)
    rec[2, :n] = rec[4, :n] = 1 / s ** 2
    rec[5, :n] = rng.uniform(*opacity, n)
    rec[6:9, :n] = rng.uniform(0, 255, (3, n))
    bounds = torch.tensor([0, n], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    return tuple(t.to(card) for t in (torch.from_numpy(rec), bounds, zero, zero))


def test_compositor_kernels_on_a_heavy_tile_that_never_saturates(card):
    # 200,000 faint one-pixel splats: every pixel stays alive to the end, so
    # every warp walks all 782 batches
    rec, bounds, ox, oy = _one_tile(200_000, 5, (0.5, 0.8), (0.004, 0.0048), card)
    got, d_got = _compare_compositor(rec, bounds, ox, oy, pw=32, ph=32, chunk=256, **KW)
    assert float(got[..., 3].min()) > 0.01 and float(got[..., 3].max()) < 0.999
    assert bool(d_got[:, 199_000:200_000].any())         # the walk reaches the end


def test_compositor_kernels_on_a_tile_that_saturates_in_its_first_batch(card):
    # wide opaque splats: every pixel is done within a few records, and the
    # gradient of all later ones is written as zero
    rec, bounds, ox, oy = _one_tile(5000, 6, (20.0, 40.0), (0.9, 0.99), card)
    got, d_got = _compare_compositor(rec, bounds, ox, oy, pw=32, ph=32, chunk=256, **KW)
    assert float(got[..., 3].max()) <= 0.01
    assert not d_got[:, 256:].any() and bool(d_got[:, :8].any())


@pytest.mark.parametrize("chunk", [64, 256, 1024])
def test_compositor_kernels_on_records_crowded_on_saturated_pixels(card, chunk):
    # 60,000 small opaque splats on a few pixels that saturate at once, mixed
    # in depth with 600 faint wide ones that the rest of the tile, alive to
    # the end, does blend: the kernels stage only what reaches the box around
    # the live pixels, a handful out of each pass, and the rest gets zeros
    rng = np.random.default_rng(chunk)
    n, wide = 60_600, 600
    rec = np.zeros((9, n + 5), np.float32)
    rec[0, :n], rec[1, :n] = rng.normal(24.0, 0.8, n), rng.normal(7.0, 0.8, n)
    s = rng.uniform(0.3, 0.6, n)
    rec[5, :n] = rng.uniform(0.5, 0.99, n)
    far = rng.choice(n, wide, replace=False)
    rec[0, far], rec[1, far] = rng.uniform(-2, 34, (2, wide))
    s[far] = rng.uniform(1.0, 4.0, wide)
    rec[5, far] = rng.uniform(0.004, 0.01, wide)
    rec[2, :n] = rec[4, :n] = 1 / s ** 2
    rec[6:9, :n] = rng.uniform(0, 255, (3, n))
    bounds = torch.tensor([0, n], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    args = tuple(t.to(card) for t in (torch.from_numpy(rec), bounds, zero, zero))
    got, d_got = _compare_compositor(*args, pw=32, ph=32, chunk=chunk, **KW)
    trans = got[0, :, 3].view(32, 32)
    assert float(trans[7, 24]) <= 0.01 and float(trans[28, 4]) > 0.5
    late = torch.from_numpy(far[far > n - 5000]).to(card)
    assert bool(d_got[:, late].any())                    # the walk reaches the end
    crowd = torch.ones(n, dtype=torch.bool)
    crowd[far] = False
    crowd[:5000] = False
    untouched = ~d_got[:, :n].any(dim=0)                 # behind saturation: zeros
    assert float(untouched[crowd.to(card)].float().mean()) > 0.9


@pytest.mark.parametrize("pw,ph", [(32, 32), (16, 16), (10, 7)])
def test_compositor_kernels_on_records_centred_on_patch_borders(card, pw, ph):
    # centres on and half a pixel off every patch and tile border, sizes
    # such that the skip test decides at the patch's edge
    px, py = kc.patch_shape(pw)
    xs = [x + d for x in range(0, pw + 1, px) for d in (-0.5, 0.0, 0.5)] + [pw - 1.0]
    ys = [y + d for y in range(0, ph + 1, py) for d in (-0.5, 0.0, 0.5)] + [ph - 1.0]
    rng = np.random.default_rng(pw)
    cx, cy = (a.ravel() for a in np.meshgrid(xs, ys))
    cx, cy = np.tile(cx, 3), np.tile(cy, 3)
    n = cx.size
    order = rng.permutation(n)
    rec = np.zeros((9, n), np.float32)
    rec[0], rec[1] = cx[order], cy[order]
    s = rng.uniform(0.4, 3.0, n)
    rec[2], rec[4] = 1 / s ** 2, 1 / (s * rng.uniform(0.5, 2.0, n)) ** 2
    rec[3] = rng.uniform(-0.5, 0.5, n) * np.sqrt(rec[2] * rec[4])
    rec[5] = rng.uniform(0.004, 0.3, n)
    rec[6:9] = rng.uniform(0, 255, (3, n))
    bounds = torch.tensor([0, n], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    args = tuple(t.to(card) for t in (torch.from_numpy(rec), bounds, zero, zero))
    _compare_compositor(*args, pw=pw, ph=ph, chunk=64, **KW)


@pytest.mark.parametrize("counts", [
    [0, 0, 300, 40], [300, 40, 0, 0], [50, 0, 0, 0, 700, 0, 0, 9], [0, 0, 0], [0, 17]])
def test_compositor_kernels_with_empty_tiles_first_last_and_in_a_row(card, counts):
    pw = ph = 32
    rng = np.random.default_rng(len(counts))
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n, tiles = int(bounds[-1]), len(counts)
    tile = np.repeat(np.arange(tiles), counts)
    rec = np.zeros((9, n + 3), np.float32)
    rec[0, :n] = tile * pw + rng.uniform(0, pw, n)
    rec[1, :n] = rng.uniform(0, ph, n)
    s = rng.uniform(0.05, 0.3, n)
    rec[2, :n], rec[4, :n] = s, s * rng.uniform(0.5, 1.5, n)
    rec[5, :n] = rng.uniform(0.05, 0.99, n)
    rec[6:9, :n] = rng.uniform(0, 255, (3, n))
    ox = torch.arange(tiles, dtype=torch.int32) * pw
    args = tuple(t.to(card) for t in (
        torch.from_numpy(rec), torch.from_numpy(bounds), ox,
        torch.zeros(tiles, dtype=torch.int32)))
    got, _ = _compare_compositor(*args, pw=pw, ph=ph, chunk=128, **KW)
    empty = torch.tensor(counts) == 0
    assert bool((got[empty.to(card)] == torch.tensor([0.0, 0, 0, 1]).to(card)).all())


def test_compositor_kernels_refuse_a_tile_shape_they_cannot_map(card):
    rec, bounds, ox, oy = _records(3, 2, 50, 2048, 1, card)
    with pytest.raises(ValueError, match="out of range"):
        kc.composite_fwd(rec, bounds, ox, oy, pw=2048, ph=1, chunk=64, **KW)
    with pytest.raises(ValueError, match="out of range"):
        kc.composite_fwd(rec, bounds, ox, oy, pw=64, ph=64, chunk=64, **KW)


@pytest.mark.parametrize("capacity", [4096, 1 << 16])
def test_segsum_kernel_matches_plain(card, capacity):
    g = torch.Generator().manual_seed(capacity)
    counts = torch.randint(0, 9, (7001,), generator=g).to(torch.int32)
    counts[5], counts[6] = 900, 0
    cum = counts.cumsum(0).to(torch.int32).to(card)
    assert (int(cum[-1]) > capacity) == (capacity == 4096)     # overflow case
    cot = torch.randn((9, capacity), generator=g).to(card)
    before = kr.segsum.launches
    got, ref = kr.segsum(cot, cum), kr.segsum_plain(cot, cum)
    assert kr.segsum.launches == before + 2            # the sums, the carries
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    assert float(((got - ref).abs() / scale).max()) <= 1e-5
    assert not got[:, (counts == 0).to(card)].any()
    assert torch.equal(got, kr.segsum(cot, cum))
    assert kr.segsum(cot, cum[:0]).shape == (9, 0)


def _off_grid(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past the 16-byte
    grid, so that no row of it is 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


@pytest.mark.parametrize("name", CASES + ["off_grid_inputs"])
def test_expand_kernel_bit_equal_to_plain_on_the_partition_cases(card, name):
    counts, capacity = partition_case(name if name in CASES else "overflow")
    table = [torch.from_numpy(a).to(card) for a in splat_table(counts, 1)]
    cum = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(card)
    if name == "off_grid_inputs":
        table, cum = [_off_grid(t) for t in table], _off_grid(cum)
    kw = dict(capacity=capacity, gx=GX, num_tiles=GX * GY, pw=PW, ph=PH,
              alpha_min=1 / 255)
    before = kr.expand.launches
    with torch.no_grad():
        got = kr.expand(*table, cum, **kw)
    assert kr.expand.launches == before + 1
    want = kr.expand_plain(*table, cum, **kw)
    for what, a, b in zip(("fields", "tile", "depth"), got, want):
        assert torch.equal(a, b), what
    total = min(int(counts.sum()), capacity)
    assert (got[1][total:] == GX * GY).all() and not got[0][:, total:].any()
    assert 0 < int((got[1][:total] < GX * GY).sum()) < total or name == "one_splat"


@pytest.mark.parametrize("name", CASES + ["off_grid_g"])
def test_segsum_kernel_matches_plain_on_the_partition_cases(card, name):
    counts, capacity = partition_case(name if name in CASES else "large_splat")
    cum = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(card)
    rng = np.random.default_rng(3)
    # centred on 1, so that no splat's sum cancels: 1e-5 of the row's scale
    # then measures the kernel's rounding, not the conditioning of one sum
    normal = torch.from_numpy(1.0 + rng.standard_normal((9, capacity)).astype(np.float32))
    # multiples of 1/64: every order of summing a splat's records is exact,
    # so a record misassigned, repeated or dropped shows as a difference
    dyadic = torch.from_numpy((rng.integers(-512, 513, (9, capacity)) / 64)
                              .astype(np.float32))
    empty = torch.from_numpy(counts == 0).to(card)
    for cot in (normal.to(card), dyadic.to(card)):
        if name == "off_grid_g":
            cot = _off_grid(cot)
        before = kr.segsum.launches
        got, ref = kr.segsum(cot, cum), kr.segsum_plain(cot, cum)
        assert kr.segsum.launches == before + 2
        scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        assert float(((got - ref).abs() / scale).max()) <= 1e-5
        assert not got[:, empty].any()
        assert torch.equal(got, kr.segsum(cot, cum))
    assert torch.equal(got, ref)                         # the dyadic cotangent


def _small(device, n=150, w=128, h=128):
    scene = {k: v for k, v in ply_io.make_synthetic_scene(n, seed=3, extent=2.0).items()
             if k != "sh_rest"}
    a = port.camera_args(port.Camera(0.0, 0.0, -6.0, width=w, height=h))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"],
            a["tan_fovy"], w, h)
    return scene, convert.params_from_numpy(scene, device), args


def _grads(params, args, cfg):
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    img, _ = render_arrays(p, *args, cfg)
    loss = ((img[..., :3] - 0.2) ** 2).mean() + 0.1 * img[..., 3].mean()
    return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


@pytest.mark.parametrize("depth_key", ["pair", "packed"])
def test_frame_gradients_card_vs_cpu(card, depth_key):
    cfg = port.RenderConfig(chunk=64, dup_capacity_factor=24.0, depth_key=depth_key)
    _, on_card, args = _small(card)
    _, on_cpu, _ = _small("cpu")
    g_card, g_cpu = _grads(on_card, args, cfg), _grads(on_cpu, args, cfg)
    for k, want in g_cpu.items():
        err = float((g_card[k].cpu() - want).abs().max() / want.abs().max())
        assert err <= 5e-3, (k, err)
    again = _grads(on_card, args, cfg)
    assert all(torch.equal(again[k], g_card[k]) for k in g_card)


def test_double_backward_is_refused(card):
    cfg = port.RenderConfig(chunk=64, dup_capacity_factor=24.0)
    _, params, args = _small(card)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    img, _ = render_arrays(p, *args, cfg)
    with pytest.raises(NotImplementedError, match="no backward"):
        torch.autograd.grad(img.sum(), list(p.values()), create_graph=True)


def test_fit_scene_resumes_bit_for_bit_on_the_card(card, tmp_path):
    w = h = 64
    scene = {k: v for k, v in ply_io.make_synthetic_scene(25, seed=6, extent=1.2).items()
             if k != "sh_rest"}
    scene["opacities"] = np.clip(scene["opacities"], 0.4, 0.9)
    cam = port.Camera(0.0, 0.0, -4.0, width=w, height=h)
    cfg = port.RenderConfig(chunk=32, dup_capacity_factor=32.0)
    target = render_stats(convert.params_from_numpy(scene, card), cam,
                          cfg)[0][..., :3].cpu().numpy()
    noisy = dict(scene, colors=np.clip(scene["colors"] + 30.0, 0, 255))
    tc = trainer.TrainConfig(steps=8)
    mid = str(tmp_path / "mid.npz")
    ref, hist = trainer.fit_scene(noisy, [target], [cam], cfg, tc, verbose=False)
    assert ref["means"].device.type == "cuda"              # the default device
    assert hist[-1]["loss"] < hist[0]["loss"]
    trainer.fit_scene(noisy, [target], [cam], cfg, dataclasses.replace(tc, steps=4),
                      verbose=False, save_every=4, checkpoint_path=mid)
    resumed, _ = trainer.fit_scene(noisy, [target], [cam], cfg, tc, verbose=False,
                                   resume=mid)
    for k in ref:
        assert torch.equal(ref[k], resumed[k]), f"resume diverged on {k}"


TILE = 4096          # values a block of csrc/scan.cu scans


def _counts(n, seed, lo=0, hi=100):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32))


@pytest.mark.parametrize("n", [1, 31, TILE - 1, TILE, TILE + 1, 1_000_003, 3_616_103,
                               67_108_869])
def test_cumsum_kernel_matches_torch_cumsum(card, n):
    assert ks._library()[1] == TILE
    x = _counts(n, n).to(card)
    before = ks.cumsum.launches
    got = ks.cumsum(x)
    assert ks.cumsum.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.cumsum(x, 0, dtype=torch.int32))


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
def test_cumsum_kernel_on_views_off_the_16_byte_grid(card, offset):
    # the allocator hands out 16-byte aligned blocks; the view starts 4, 8 or
    # 12 bytes in, and the last case is aligned again but ends mid-tile
    whole = _counts(3 * TILE + 77, offset).to(card)
    x = whole[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 4)
    assert torch.equal(ks.cumsum(x), torch.cumsum(x, 0, dtype=torch.int32))


def test_cumsum_kernel_zero_and_wrapping_inputs(card):
    zeros = torch.zeros(5 * TILE + 3, dtype=torch.int32, device=card)
    assert not ks.cumsum(zeros).any()
    # sums pass 2^31 many times over, and negative values too: int32 wraps
    for lo, hi in ((2 ** 30, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)):
        x = _counts(9 * TILE + 5, hi % 97, lo, hi).to(card)
        want = torch.cumsum(x, 0, dtype=torch.int32)
        assert int(want.min()) < 0 < int(want.max())
        assert torch.equal(ks.cumsum(x), want)


def test_cumsum_kernel_200_launches_running(card):
    # back to back on one stream, nothing synchronised in between: a torn
    # descriptor or scratch seen stale shows as one result that differs
    x = _counts(3_616_103, 200).to(card)
    want = torch.cumsum(x, 0, dtype=torch.int32)
    outs = [ks.cumsum(x) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def _u32_keys(n, seed, hi=2 ** 32):
    keys = np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint32)
    return torch.from_numpy(keys.view(np.int32))


def _plain_pass(k, v, counts, shift, bits):
    """One pass through the plain versions, fed the counts the kernel got."""
    return rx.radix_scatter_plain(k, v, rx.chunk_offsets_plain(k, counts, shift, bits),
                                  shift, bits)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,nv", [(1, 1), (4096, 0), (5000, 3), (300_001, 9)])
def test_radix_kernels_match_plain(card, bits, n, nv):
    # the counts of every pass and the placement of each pass equal the
    # plain versions exactly, ragged last chunk included
    k = _u32_keys(n, n + bits).to(card)
    v = torch.arange(nv * n, dtype=torch.int32, device=card).view(nv, n)
    h0, s0 = rx.radix_counts.launches, rx.radix_scatter.launches
    counts = rx.radix_counts(k, 32, bits)
    assert torch.equal(counts, rx.radix_counts_plain(k, 32, bits))
    for p in range(32 // bits):
        got = rx.radix_scatter(k, v, counts[p], p * bits, bits)
        ref = _plain_pass(k, v, counts[p], p * bits, bits)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        k, v = got
    torch.cuda.synchronize()
    assert (rx.radix_counts.launches, rx.radix_scatter.launches) == (
        h0 + 1, s0 + 32 // bits)
    assert bool((kr.u32_values(k).diff() >= 0).all())


def _scatter_keys(kind, n):
    if kind == "equal":
        return np.full(n, 0x5A5A5A5A, np.uint32)
    if kind == "one_a_digit":                   # every byte walks all 256 digits
        return (np.arange(n, dtype=np.uint32) % 256) * np.uint32(0x01010101)
    rnd = np.random.default_rng(n).integers(0, 2 ** 32, n, dtype=np.uint32)
    if kind == "sorted":
        return np.sort(rnd)
    if kind == "reversed":
        return np.sort(rnd)[::-1].copy()
    assert kind == "random"
    return rnd


KINDS = ["equal", "one_a_digit", "sorted", "reversed", "random"]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("nv", [0, 1, 9])
@pytest.mark.parametrize("n", [1, rx.CHUNK - 1, rx.CHUNK + 1, 1_234_567])
@pytest.mark.parametrize("kind", KINDS)
def test_radix_scatter_kernel_matches_plain(card, kind, n, nv, bits):
    k = torch.from_numpy(_scatter_keys(kind, n).view(np.int32)).to(card)
    v = torch.arange(nv * n, dtype=torch.int32, device=card).view(nv, n)
    counts = rx.radix_counts(k, 32, bits)
    assert torch.equal(counts, rx.radix_counts_plain(k, 32, bits))
    for shift in (0, 32 - bits):
        got = rx.radix_scatter(k, v, counts[shift // bits], shift, bits)
        ref = _plain_pass(k, v, counts[shift // bits], shift, bits)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        again = rx.radix_scatter(k, v, counts[shift // bits], shift, bits)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_radix_scatter_kernel_on_an_unaligned_key_view(card):
    n = 3 * rx.CHUNK
    whole = torch.from_numpy(_scatter_keys("random", n + 1).view(np.int32)).to(card)
    k = whole[1:]
    v = torch.arange(n, dtype=torch.int32, device=card).view(1, n)
    counts = rx.radix_counts(k)
    assert torch.equal(counts, rx.radix_counts_plain(k))
    got, ref = rx.radix_scatter(k, v, counts[1], 8), _plain_pass(k, v, counts[1], 8, 8)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 4099, 1_000_003])
def test_radix_counts_kernel_on_views_off_the_16_byte_grid(card, offset, n):
    # the scalars before the first 16-byte boundary and after the last whole
    # vector, at every offset, and fewer keys than the head
    whole = _u32_keys(n + offset, n + offset).to(card)
    k = whole[offset:]
    for key_bits, bits in ((32, 8), (32, 4), (10, 8), (9, 4)):
        assert torch.equal(rx.radix_counts(k, key_bits, bits),
                           rx.radix_counts_plain(k, key_bits, bits))


ONESWEEP_N = [rx.CHUNK - 5, rx.CHUNK, 3 * rx.CHUNK + 1]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("nv", [0, 1, 9])
@pytest.mark.parametrize("n", ONESWEEP_N)
@pytest.mark.parametrize("kind", KINDS)
def test_onesweep_radix_sort_matches_torch_sort_and_the_plain_passes(card, kind, n, nv,
                                                                    bits):
    # through an unaligned view of the keys: the counts take their scalar
    # head, the scatters their 4-byte loads
    whole = torch.from_numpy(np.concatenate(
        [np.zeros(1, np.uint32), _scatter_keys(kind, n)]).view(np.int32)).to(card)
    keys = whole[1:]
    rows = [torch.randn(n, generator=torch.Generator().manual_seed(r)).to(card)
            for r in range(nv)]
    h0, s0 = rx.radix_counts.launches, rx.radix_scatter.launches
    sk, sv = rx.radix_sort(keys, rows, 32, bits)
    assert (rx.radix_counts.launches, rx.radix_scatter.launches) == (
        h0 + 1, s0 + 32 // bits)
    rk, ri = torch.sort(kr.u32_values(keys), stable=True)
    assert torch.equal(kr.u32_values(sk), rk)
    for got, row in zip(sv, rows):
        assert torch.equal(got, row[ri])
    # and pass for pass against the plain versions on the CPU
    k, v = keys.cpu(), (torch.stack(rows).view(torch.int32).cpu() if rows
                        else torch.zeros((0, n), dtype=torch.int32))
    counts = rx.radix_counts_plain(k, 32, bits)
    for p in range(32 // bits):
        k, v = _plain_pass(k, v, counts[p], p * bits, bits)
    assert torch.equal(sk.cpu(), k)
    assert all(torch.equal(a.cpu().view(torch.int32), b) for a, b in zip(sv, v))


def test_onesweep_radix_sort_200_sorts_running(card):
    # back to back on one stream, nothing synchronised in between: a
    # descriptor seen torn or scratch seen stale shows as one sort that differs
    n = 1_000_003
    keys = _u32_keys(n, 17).to(card)
    idx = torch.arange(n, dtype=torch.int32, device=card)
    rk, ri = torch.sort(kr.u32_values(keys), stable=True)
    outs = [rx.radix_sort(keys, (idx,), 32) for _ in range(200)]
    torch.cuda.synchronize()
    assert all(torch.equal(kr.u32_values(sk), rk) and torch.equal(si.to(torch.int64), ri)
               for sk, (si,) in outs)


def test_onesweep_radix_sort_on_two_streams(card):
    # each stream has its own scratch: sorts of two streams may overlap
    n = 2_000_001
    keys = [_u32_keys(n, s).to(card) for s in (21, 22)]
    idx = torch.arange(n, dtype=torch.int32, device=card)
    want = [torch.sort(kr.u32_values(k), stable=True)[1] for k in keys]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[j].append(rx.radix_sort(keys[j], (idx,), 32)[1][0])
    torch.cuda.synchronize()
    for j in range(2):
        assert all(torch.equal(si.to(torch.int64), want[j]) for si in outs[j])


@pytest.mark.parametrize("bits", [4, 8])
def test_radix_sort_matches_torch_sort_on_the_card(card, bits):
    n = 1_234_567
    keys = _u32_keys(n, 5)
    keys[:4] = torch.tensor([-1, 0, -1, -2], dtype=torch.int32)   # 0xFFFFFFFF ...
    keys[n // 2:n // 2 + 50_000] = 77                             # a long tie
    keys = keys.to(card)
    idx = torch.arange(n, dtype=torch.int32, device=card)
    payload = torch.randn(n, generator=torch.Generator().manual_seed(1)).to(card)
    sk, (si, sp) = rx.radix_sort(keys, (idx, payload), 32, bits)
    rk, ri = torch.sort(kr.u32_values(keys), stable=True)
    assert torch.equal(kr.u32_values(sk), rk)
    assert torch.equal(si.to(torch.int64), ri)
    assert torch.equal(sp, payload[ri])
    again = rx.radix_sort(keys, (idx, payload), 32, bits)
    assert torch.equal(again[0], sk) and torch.equal(again[1][0], si)
    # a tile-only key: two passes of 8 bits, three of 4
    tiles = torch.randint(0, 513, (n,), generator=torch.Generator().manual_seed(2),
                          dtype=torch.int32).to(card)
    st, (ti,) = rx.radix_sort(tiles, (idx,), 10, bits)
    rt, rti = torch.sort(tiles, stable=True)
    assert torch.equal(st, rt) and torch.equal(ti.to(torch.int64), rti)


SINGLE_KEY = {
    "packed+radix": dict(depth_key="packed", record_sort="radix"),
    "hoisted": dict(hoist_depth_sort=True),
    "hoisted+radix": dict(hoist_depth_sort=True, record_sort="radix"),
}


@pytest.mark.parametrize("name", list(SINGLE_KEY))
def test_single_key_sort_frames_card_vs_cpu(card, name):
    base = dict(chunk=64, dup_capacity_factor=24.0)
    cfg = port.RenderConfig(**base, **SINGLE_KEY[name])
    like = port.RenderConfig(**base, **{k: v for k, v in SINGLE_KEY[name].items()
                                        if k != "record_sort"})
    _, on_card, args = _small(card)
    _, on_cpu, _ = _small("cpu")
    h0, s0 = rx.radix_counts.launches, rx.radix_scatter.launches
    r0 = rs.record_sort_splats.launches
    with torch.no_grad():
        img, stats = render_arrays(on_card, *args, cfg)
        used = (rx.radix_counts.launches - h0, rx.radix_scatter.launches - s0,
                rs.record_sort_splats.launches - r0)
        img_like, _ = render_arrays(on_card, *args, like)
        img_cpu, stats_cpu = render_arrays(on_cpu, *args, cfg)
    # the packed key runs the record sort stage on either route: one count,
    # a scatter a pass (4) carrying the splat ids (no gradient), the
    # fields' gather; the hoisted radix route one count and a scatter a
    # pass of the tile id (2)
    assert used == ((0, 0, 6) if name.startswith("packed") else
                    (0, 0, 0) if cfg.record_sort == "lax" else (1, 2, 0))
    assert torch.equal(img, img_like)            # the engine does not show
    assert float((img.cpu() - img_cpu).abs().max()) <= 1e-4
    assert all(stats[k].item() == stats_cpu[k].item() for k in stats_cpu)
    g_card, g_cpu = _grads(on_card, args, cfg), _grads(on_cpu, args, cfg)
    for k, want in g_cpu.items():
        err = float((g_card[k].cpu() - want).abs().max() / want.abs().max())
        assert err <= 5e-3, (k, err)


def _sort_records(key, tiles, c, seed):
    """tile ids (a fifth the invalid tile, a run of one tile), depths with
    ties and both zeros, nine field rows."""
    g = torch.Generator().manual_seed(seed)
    tile = torch.randint(0, tiles, (c,), generator=g, dtype=torch.int32)
    tile[torch.rand(c, generator=g) < 0.2] = tiles
    tile[c // 3:c // 3 + 300] = 5
    values = torch.tensor([-1.5, -0.0, 0.0, 0.25, 0.25, 0.7, 1.0, 2.0e9])
    depth = torch.where(torch.rand(c, generator=g) < 0.5,
                        values[torch.randint(0, 8, (c,), generator=g)],
                        torch.rand(c, generator=g))
    return tile, depth, torch.randn((9, c), generator=g)


def _one_a_splat(fields, words, tiles, key, inverse=True):
    """The stage's forward on records that are each a splat of its own:
    (sorted fields, bounds, inverse) of the records' own fields."""
    c = fields.shape[1]
    ids = torch.arange(c, dtype=torch.int32, device=fields.device)
    return rs.record_sort_splats_fwd(fields, kt.splat_pairs_plain(fields), ids, words, tiles,
                                     key, inverse=inverse)


@pytest.mark.parametrize("key,tiles", [("pair", 512), ("pair", 2040), ("packed", 512),
                                       ("packed", 37)])
@pytest.mark.parametrize("c", [1, 3, rx.CHUNK - 1, rx.CHUNK, rx.CHUNK + 5, 300_001])
def test_record_sort_kernels_match_plain(card, key, tiles, c):
    tile, depth, fields = _sort_records(key, tiles, c, c + tiles)
    words_cpu = rs.words_of(tile, depth, key)
    want = rs.record_sort_plain(fields, words_cpu, tiles, key)
    words = tuple(w.to(card) for w in words_cpu)
    f = fields.to(card)
    before = rs.record_sort_splats.launches
    sf, bounds, inv = _one_a_splat(f, words, tiles, key)
    lo_p, hi_p = rs.passes(tiles, key)
    assert rs.record_sort_splats.launches - before == 3 + lo_p + hi_p
    assert torch.equal(sf.cpu(), want[0]) and torch.equal(bounds.cpu(), want[1])
    assert torch.equal(inv.cpu(), rs.inverse_plain(want[2]))
    again = _one_a_splat(f, words, tiles, key)
    assert all(torch.equal(a, b) for a, b in zip(again, (sf, bounds, inv)))
    gc = torch.randn((9, c), generator=torch.Generator().manual_seed(4))
    for mode, paired in (("f32", 0), ("bf16", 8)):
        old, rs.kr.BWD_COT_PACK = rs.kr.BWD_COT_PACK, mode
        try:
            got = rs.record_unsort(gc.to(card), inv)
        finally:
            rs.kr.BWD_COT_PACK = old
        assert torch.equal(got.cpu(), rs.unsort_plain(gc, want[2], paired)), mode


@pytest.mark.parametrize("key", ["pair", "packed"])
def test_record_sort_kernels_on_views_off_the_16_byte_grid(card, key):
    # the counts' scalar loads, the scatter's narrow loads, the gathers'
    # narrow loads of ids and stores of fields
    c = 50_001
    tile, depth, fields = _sort_records(key, 512, c + 1, 9)
    words = rs.words_of(tile, depth, key)
    want = rs.record_sort_plain(fields[:, 1:].contiguous(),
                                tuple(w[1:] for w in words), 512, key)
    on = tuple(w.to(card)[1:] for w in words)
    assert on[0].data_ptr() % 16 == 4
    f = fields[:, 1:].contiguous().to(card)
    ids = torch.arange(-1, c, dtype=torch.int32, device=card)[1:]
    assert ids.data_ptr() % 16 == 4
    sf, bounds, inv = rs.record_sort_splats_fwd(f, kt.splat_pairs_plain(f), ids, on, 512, key)
    assert torch.equal(sf.cpu(), want[0]) and torch.equal(bounds.cpu(), want[1])
    assert torch.equal(inv.cpu(), rs.inverse_plain(want[2]))


@pytest.mark.parametrize("depth_key", ["pair", "packed"])
def test_record_sort_stage_in_the_frame_and_its_gradients(card, depth_key):
    # the kernel stage and the plain stage give the same frame and
    # gradients, bit for bit, on the card
    cfg = port.RenderConfig(chunk=64, dup_capacity_factor=24.0, depth_key=depth_key)
    _, on_card, args = _small(card)
    r0, u0 = rs.record_sort_splats.launches, rs.record_unsort.launches
    g_kernel = _grads(on_card, args, cfg)
    assert rs.record_sort_splats.launches > r0 and rs.record_unsort.launches == u0 + 1
    fwd, unsort = rs.record_sort_splats_fwd, rs.record_unsort
    rs.record_sort_splats_fwd = (
        lambda f, pairs, sid, w, t, k, passes_model=False, inverse=True:
        rs.record_sort_splats_plain(f, sid, w, t, k))
    rs.record_unsort = lambda g, order, paired_rows=None: rs.unsort_plain(g, order)
    try:
        g_plain = _grads(on_card, args, cfg)
    finally:
        rs.record_sort_splats_fwd, rs.record_unsort = fwd, unsort
    assert all(torch.equal(g_kernel[k], g_plain[k]) for k in g_plain)


@pytest.mark.parametrize("name", CASES + ["off_grid_inputs"])
@pytest.mark.parametrize("key", ["pair", "packed"])
def test_expand_ids_bit_equal_to_plain_on_the_partition_cases(card, name, key):
    # the record sort mode of the expansion: splat ids (n past total) in
    # place of the fields, the tile and depth unchanged, the sort word of
    # the two; the fields gathered back by splat equal the field mode's
    counts, capacity = partition_case(name if name in CASES else "overflow")
    host = [torch.from_numpy(a) for a in splat_table(counts, 1)]
    cum_h = torch.from_numpy(np.cumsum(counts).astype(np.int32))
    table, cum = [t.to(card) for t in host], cum_h.to(card)
    if name == "off_grid_inputs":
        table, cum = [_off_grid(t) for t in table], _off_grid(cum)
    kw = dict(capacity=capacity, gx=GX, num_tiles=GX * GY, pw=PW, ph=PH, alpha_min=1 / 255)
    before = kr.expand.launches
    with torch.no_grad():
        got = kr.expand_ids(*table, cum, **kw, key=key)
        full = kr.expand(*table, cum, **kw)
        fields = rs.splat_fields(table[0], kt.splat_pairs_plain(table[0]), got[0], cum)
    assert kr.expand.launches == before + 2
    want = kr.expand_ids(*host, cum_h, **kw, key=key)
    for what, a, b in zip(("splat ids", "tile", "depth", "word"), got, want):
        assert torch.equal(a.cpu(), b), what
    assert torch.equal(want[0], kr.splat_ids_plain(cum_h, capacity))
    assert all(torch.equal(a, b) for a, b in zip(got[1:3], full[1:]))
    assert torch.equal(got[3], kr.sort_word(full[1], full[2], key))
    assert torch.equal(fields, full[0])


def _splat_case(n, c, seed):
    """Splat fields (9, n), splat ids (c,) in [0, n] (a tenth of them n),
    a cotangent (9, c)."""
    g = torch.Generator().manual_seed(seed)
    fields = torch.randn((9, n), generator=g)
    sid = torch.randint(0, n + 1, (c,), generator=g, dtype=torch.int32)
    sid[torch.rand(c, generator=g) < 0.1] = n
    return fields, sid, torch.randn((9, c), generator=g)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 100_003])
def test_id_gather_and_pair_gather_match_plain(card, n):
    fields, sid, _ = _splat_case(n, 4 * n + 7, n)
    pairs = kt.splat_pairs_plain(fields).to(card)
    sid_c = sid.to(card)
    for c in (0, 1, 3, 4, 4 * n + 7):
        idx = torch.randperm(4 * n + 7, generator=torch.Generator().manual_seed(c))[:c]
        idx = idx.to(torch.int32)
        ids = sid[idx.to(torch.int64)]
        for ix in (idx.to(card), _off_grid(idx.to(card)) if c else idx.to(card)):
            got = rs._id_gather(sid_c, ix)
            assert torch.equal(got.cpu(), ids), c
            assert torch.equal(rs._pair_gather(pairs, got).cpu(),
                               rs.fields_of_splats_plain(fields, ids)), c
        if c:
            assert torch.equal(rs._pair_gather(pairs, _off_grid(ids.to(card))).cpu(),
                               rs.fields_of_splats_plain(fields, ids)), c


@pytest.mark.parametrize("n", [1, 127, 128, 129, 50_001])
def test_splat_table_stores_the_pair_layout(card, n):
    # kernel 10's store option: the pair layout of the fields it writes,
    # row n zero, and nothing else changed
    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath

    cfg = port.RenderConfig(chunk=64, dup_capacity_factor=24.0)
    _, params, args = _small(card, n=n)
    view, vp = (torch.as_tensor(m, dtype=torch.float32, device=card) for m in args[:2])
    before = kt.splat_table.launches
    with torch.no_grad():
        plain, prep0 = fastpath.splat_table(params, view, vp, *args[2:], cfg)
        with_pairs, prep = fastpath.splat_table(params, view, vp, *args[2:], cfg, pairs=True)
    assert kt.splat_table.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(plain, with_pairs))
    assert all(torch.equal(prep0[k], prep[k]) for k in prep0)
    assert torch.equal(prep["pairs"], kt.splat_pairs_plain(plain[0]))


@pytest.mark.parametrize("key,tiles", [("pair", 512), ("pair", 2040), ("packed", 512),
                                       ("packed", 37)])
@pytest.mark.parametrize("n,c", [(0, 5), (1, 1), (40, 3), (700, rx.CHUNK + 5),
                                 (100_000, 300_001), (5, 0)])
def test_record_sort_splats_match_plain_and_the_field_stage(card, key, tiles, n, c):
    tile, depth, _ = _sort_records(key, tiles, c, c + tiles + n)
    fields, sid, gc = _splat_case(n, c, c + n)
    words_cpu = rs.words_of(tile, depth, key)
    want = rs.record_sort_splats_plain(fields, sid, words_cpu, tiles, key)
    rec_f = rs.fields_of_splats_plain(fields, sid)
    old = rs.record_sort_plain(rec_f, words_cpu, tiles, key)
    assert all(torch.equal(a, b) for a, b in zip(want, old))
    words = tuple(w.to(card) for w in words_cpu)
    f, pairs = fields.to(card), kt.splat_pairs_plain(fields).to(card)
    before = rs.record_sort_splats.launches
    sf, bounds, inv = rs.record_sort_splats_fwd(f, pairs, sid.to(card), words, tiles, key)
    lo_p, hi_p = rs.passes(tiles, key)
    assert rs.record_sort_splats.launches - before == ((3 + lo_p + hi_p) if c else 0)
    assert torch.equal(sf.cpu(), want[0]) and torch.equal(bounds.cpu(), want[1])
    assert torch.equal(inv.cpu(), rs.inverse_plain(want[2]))
    # the frame without a gradient stores no inverse and carries the splat
    # ids through the passes: one launch fewer
    before = rs.record_sort_splats.launches
    n_sf, n_bounds, n_inv = rs.record_sort_splats_fwd(f, pairs, sid.to(card), words, tiles,
                                                      key, inverse=False)
    assert n_inv is None and torch.equal(n_sf, sf) and torch.equal(n_bounds, bounds)
    assert rs.record_sort_splats.launches - before == ((2 + lo_p + hi_p) if c else 0)


class _FieldSort(torch.autograd.Function):
    """The stable sort of the records' own fields (``record_sort_plain``),
    with ``unsort_plain`` as its gradient: the route before the stage
    sorted by splat."""

    @staticmethod
    def forward(ctx, fields, words, num_tiles, key):
        sf, bounds, si = rs.record_sort_plain(fields, words, num_tiles, key)
        ctx.save_for_backward(si)
        ctx.mark_non_differentiable(bounds)
        return sf, bounds

    @staticmethod
    def backward(ctx, g, _g_bounds):
        (si,) = ctx.saved_tensors
        return rs.unsort_plain(g.contiguous(), si), None, None, None


@pytest.mark.parametrize("depth_key", ["pair", "packed"])
def test_frame_by_splat_equals_the_field_route_on_the_card(card, depth_key):
    # the frame (the stage by splat) and the route through the expansion's
    # fields and the sort of those: the same image and gradients, bit for
    # bit
    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
    from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import assemble_image

    cfg = port.RenderConfig(chunk=64, dup_capacity_factor=24.0, depth_key=depth_key)
    _, params, args = _small(card)
    n, (w, h) = params["means"].shape[0], args[6:8]
    key = fastpath.record_key(cfg)

    def field_route(p, view, vp, *a):
        view, vp = (torch.as_tensor(m, dtype=torch.float32, device=card) for m in (view, vp))
        table, prep = fastpath.splat_table(p, view, vp, *a, cfg)
        rec = kr.expand(*table, ks.cumsum(prep["counts"]),
                        **fastpath.expand_kwargs(n, w, h, cfg))
        sf, bounds = _FieldSort.apply(rec[0], rs.words_of(rec[1], rec[2], key),
                                      cfg.num_tiles, key)
        tiled, _, _ = fastpath.composite_sorted(
            sf, bounds, num_tiles=cfg.num_tiles,
            tile_ids=torch.arange(cfg.num_tiles, dtype=torch.int32, device=card),
            width=w, height=h, cfg=cfg)
        return assemble_image(tiled[:, :, :3], tiled[:, :, 3], w, h, cfg), None

    def grads(render):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        img, _ = render(p, *args)
        loss = ((img[..., :3] - 0.2) ** 2).mean() + 0.1 * img[..., 3].mean()
        return img, torch.autograd.grad(loss, list(p.values()))

    img, g = grads(lambda p, *a: render_arrays(p, *a, cfg))
    img_f, g_f = grads(field_route)
    assert torch.equal(img, img_f)
    assert all(torch.equal(a, b) for a, b in zip(g, g_f))
    # without a gradient the passes carry the splat ids (the pair key's with
    # the tile ids, one buffer of the expansion's)
    with torch.no_grad():
        assert torch.equal(render_arrays(params, *args, cfg)[0], img_f)


def test_q16_frame_card_vs_cpu_and_its_backward_raises(card):
    cfg = port.RenderConfig(chunk=64, dup_capacity_factor=24.0, depth_key="packed",
                            sort_payload="q16")
    _, on_card, args = _small(card)
    _, on_cpu, _ = _small("cpu")
    with torch.no_grad():
        img, _ = render_arrays(on_card, *args, cfg)
        img_cpu, _ = render_arrays(on_cpu, *args, cfg)
    assert float((img.cpu() - img_cpu).abs().max()) <= 1e-4
    with pytest.raises(NotImplementedError, match="inference-only"):
        _grads(on_card, args, cfg)


@pytest.mark.parametrize("k", [1, 16, 32, 64])
def test_bucketer_level_matches_plain(card, k):
    rec = bucketer_probe.make_records(512 * 40 + 100, card, seed=k)
    rec[bucketer_probe.TILE_ROW, 512:1024] = 3.0          # one bucket, 512 deep
    rec[bucketer_probe.TILE_ROW, 1500:1510] = 512.0       # no bucket
    rec[bucketer_probe.TILE_ROW, 1510:1520] = -1.0
    before = bucketer_probe.bucketer_level.launches
    got = bucketer_probe.bucketer_level(rec, k)
    assert bucketer_probe.bucketer_level.launches == before + 1
    assert got.shape == (40, 16, k * 128)
    assert torch.equal(got, bucketer_probe.bucketer_level_plain(rec, k))
    assert torch.equal(got, bucketer_probe.bucketer_level(rec, k))


@pytest.mark.parametrize("k", [1, 3, 32, 33, 64])
def test_bucketer_level_on_an_unaligned_view(card, k):
    # C not a multiple of 512 and rows that start 4 bytes off the 16-byte
    # grid (the row stride, C floats, is odd too): the copies in take 4
    # bytes where a row's address does not allow 16
    c = 512 * 9 + 77
    whole = bucketer_probe.make_records(16 * c + 1, card, seed=k).view(-1)
    rec = whole[1:16 * c + 1].view(16, c)
    assert rec.data_ptr() % 16 == 4 and rec.is_contiguous()
    rec[bucketer_probe.TILE_ROW] = torch.randint(
        -3, 516, (c,), generator=torch.Generator().manual_seed(k)).to(card).float()
    rec[bucketer_probe.TILE_ROW, 2000:2300] = 511.0          # one deep bucket
    got = bucketer_probe.bucketer_level(rec, k)
    assert got.shape == (9, 16, k * 128)
    assert torch.equal(got, bucketer_probe.bucketer_level_plain(rec, k))


@pytest.mark.parametrize("shape", [(0,), (1,), (8, 128), (1_000_003,)])
def test_probe_affine_matches_plain(card, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(card)
    before = cache_key_probe.probe_affine.launches
    got = cache_key_probe.probe_affine(x)
    assert cache_key_probe.probe_affine.launches == before + (x.numel() > 0)
    assert torch.equal(got, cache_key_probe.probe_affine_plain(x))


@pytest.mark.parametrize("offset,n", [(1, 1027), (2, 5), (3, 4096), (4, 1_000_001)])
def test_probe_affine_on_views_off_the_16_byte_grid(card, offset, n):
    # the kernel loads 16 bytes a thread only where the arrays allow it
    whole = torch.randn(n + offset, generator=torch.Generator().manual_seed(n)).to(card)
    x = whole[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 4)
    assert torch.equal(cache_key_probe.probe_affine(x),
                       cache_key_probe.probe_affine_plain(x))


def _table_scene(n, seed=0):
    """Splats around the origin before a camera at z = -4, the last few
    placed behind it, off-screen, past the fov clamp and at zero scale."""
    rng = np.random.default_rng(seed)
    a = port.camera_args(port.Camera(0.0, 0.0, -4.0, width=64, height=48))
    means = rng.uniform(-1.5, 1.5, (n, 3))
    special = np.array([[0.0, 0.2, -6.0], [9.0, 0.0, 0.0], [0.0, 40.0, 1.0],
                        [0.1, -0.1, 0.0]])[:n]
    means[n - len(special):] = special
    scales = np.exp(rng.uniform(-3.5, -1.5, (n, 3)))
    scales[-1:] = 0.0
    quats = rng.normal(size=(n, 4))
    quats /= np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-6)
    scene = dict(means=means, scales=scales, quats=quats, opacities=rng.uniform(0.02, 0.95, n),
                 colors=rng.uniform(0, 255, (n, 3)), sh_rest=rng.normal(0, 0.3, (n, 45)),
                 shift2d=rng.normal(0, 0.5, (n, 2)))
    args = (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"],
            64, 48)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in scene.items()}, args


@pytest.mark.parametrize("n,sh,row,cov6,shift,opts", [
    (1, 0, 45, False, False, {}),
    (37, 3, 45, False, True, {}),
    (129, 1, 9, True, False, dict(antialiased=True)),
    (1000, 2, 24, False, True, dict(tight_rect=False, int_tile_size=True)),
    (4099, 3, 45, True, True, dict(antialiased=True, dilation=0.0, grid_x=12, grid_y=10)),
])
def test_splat_table_kernels_match_plain(card, n, sh, row, cov6, shift, opts):
    scene, args = _table_scene(n, seed=n)
    scene["sh_rest"] = scene["sh_rest"][:, :row].contiguous()
    if cov6:
        scene["cov6"] = build_covariance(scene.pop("scales"), scene.pop("quats"))
    if not shift:
        del scene["shift2d"]
    cfg = port.RenderConfig(sh_degree=sh, **opts)
    view, vp = (torch.as_tensor(m, device=card) for m in args[:2])
    spec = (*args[2:], cfg)
    on_card = kt.table_inputs({k: v.to(card) for k, v in scene.items()}, cfg)
    before = (kt.splat_table.launches, kt.splat_table_bwd.launches)
    got = kt.splat_table_fwd(on_card, view, vp, spec)
    want = kt.splat_table_fwd_plain(on_card, view, vp, spec)
    for a, b in zip(got, want):
        if a is None:
            assert b is None
        elif a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b)
        else:
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-5, equal_nan=True)
    g = torch.randn((9, n), generator=torch.Generator().manual_seed(n)).to(card)
    g[:, n // 2] = 0.0                                       # a splat with no cotangent
    gm = torch.randn((n, 2), generator=torch.Generator().manual_seed(1)).to(card)
    gm[n // 2] = 0.0
    d_got = kt.splat_table_bwd(on_card, view, vp, spec, g, gm)
    d_want = kt.splat_table_bwd_plain(on_card, view, vp, spec, g, gm)
    assert (kt.splat_table.launches, kt.splat_table_bwd.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    assert set(d_got) == set(d_want)
    for k, want_k in d_want.items():
        assert bool(torch.isfinite(d_got[k]).all()), k
        assert not d_got[k][n // 2].any(), k
        scale = float(want_k.abs().max()) or 1.0
        assert float((d_got[k] - want_k).abs().max()) <= 1e-4 * scale, k


def test_splat_table_on_no_splats_and_through_autograd(card):
    scene, args = _table_scene(300, seed=2)
    cfg = port.RenderConfig(sh_degree=3)
    view, vp = (torch.as_tensor(m, device=card) for m in args[:2])
    empty = {k: v[:0].to(card) for k, v in scene.items()}
    (fields, tile_min, _, _), prep = kt.splat_table(empty, view, vp, *args[2:], cfg)
    assert fields.shape == (9, 0) and tile_min.shape == (0, 2) and prep["valid"].numel() == 0
    leaves = {k: v.to(card).requires_grad_(True) for k, v in scene.items()}
    (fields, _, _, _), prep = kt.splat_table(leaves, view, vp, *args[2:], cfg)
    g = torch.randn(fields.shape, generator=torch.Generator().manual_seed(0)).to(card)
    got = torch.autograd.grad((fields, prep["mean2d"]), list(leaves.values()),
                              (g, torch.ones_like(prep["mean2d"])))
    plain = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    (f_p, _, _, _), prep_p = kt.splat_table_plain(plain, view, vp, *args[2:], cfg)
    want = torch.autograd.grad((f_p, prep_p["mean2d"]), list(plain.values()),
                               (g, torch.ones_like(prep_p["mean2d"])))
    for k, a, b in zip(leaves, got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), k
    with pytest.raises(NotImplementedError, match="no backward"):
        (fields, _, _, _), _ = kt.splat_table(leaves, view, vp, *args[2:], cfg)
        torch.autograd.grad(fields, list(leaves.values()), g, create_graph=True)


# ---- the train step's kernels: Adam (csrc/adam.cu), the loss (csrc/ssim_loss.cu)

ADAM_KEYS = {"means": 3, "log_scales": 3, "quats": 4, "logit_opacities": 1, "colors": 3}


def _adam_case(n, seed, device, sh=False, offset=0):
    """raw, grads and a state three steps in, on ``device``; ``offset``
    puts every tensor that many floats past its allocation's start (off the
    16-byte grid for 1), or, given a key's name, that key's raw tensor alone
    one float past it."""
    g = torch.Generator().manual_seed(seed)
    widths = dict(ADAM_KEYS, **({"sh_rest": 45} if sh else {}))

    def t(w, scale=1.0, off=offset if isinstance(offset, int) else 0):
        x = (torch.randn(n * w + off, generator=g) * scale).to(device)
        return x[off:].view((n, w) if w > 1 else (n,))

    raw = {k: t(w, off=1) if k == offset else t(w) for k, w in widths.items()}
    grads = {k: t(w, 1e-3) for k, w in widths.items()}
    grads["colors"][: n // 3] = 0.0                          # no gradient: a zero step
    state = {"count": 3, "mu": {k: t(w, 1e-3) for k, w in widths.items()},
             "nu": {k: t(w, 1e-4).abs() for k, w in widths.items()}}
    return raw, grads, state


def _kept(raw, state):
    return ({k: v.clone() for k, v in raw.items()},
            {m: {k: v.clone() for k, v in state[m].items()} for m in ("mu", "nu")})


def _unwritten(raw, state, kept):
    for k in raw:
        assert torch.equal(raw[k], kept[0][k]), "raw was written"
        for m in ("mu", "nu"):
            assert torch.equal(state[m][k], kept[1][m][k]), "the old state was written"


# n = 7,000 and 100,003: every key ends inside a chunk (n w is no multiple
# of 4,096); offset 1 or 2: every key off the 16-byte grid, element by
# element; "quats": that key alone off the grid, the others in chunks
@pytest.mark.parametrize("n,sh,offset", [(1, False, 0), (5, False, 0), (1024, False, 0),
                                         (4097, True, 0), (100_003, True, 0),
                                         (100_003, False, 1), (3, True, 1), (5_000, True, 2),
                                         (7_000, True, 0), (7_000, True, "quats"),
                                         (100_003, False, "logit_opacities")])
def test_adam_kernel_bit_equal_to_plain(card, n, sh, offset):
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam

    seed = n + (offset if isinstance(offset, int) else len(offset))
    raw, grads, state = _adam_case(n, seed, card, sh, offset)
    kept = _kept(raw, state)
    tc = trainer.TrainConfig(lr_means_final=1.6e-6, lr_means_decay_steps=10)
    opt = trainer.make_optimizer(tc, tuple(raw))
    before = kadam.adam_update.launches
    lrs = {k: opt.learning_rate(k, 3) for k in raw}
    want_u, want_s = kadam.adam_update_plain(grads, state, lrs)
    new, got_s = opt.update(grads, state, raw)
    # from zero, p' is the update itself
    got_u, got_s2 = opt.update(grads, state, {k: torch.zeros_like(v) for k, v in raw.items()})
    torch.cuda.synchronize()
    assert kadam.adam_update.launches == before + 2
    assert got_s["count"] == got_s2["count"] == 4
    plan = kadam.plan(grads, state, lrs, raw)[0]
    for i, k in enumerate(raw):
        off_grid = offset == k or (isinstance(offset, int) and offset % 4 != 0)
        assert plan.args.vec[i] == (not off_grid), k
        assert torch.equal(new[k], raw[k] + want_u[k]), k
        assert torch.equal(got_u[k], want_u[k]), k
        for m in ("mu", "nu"):
            assert torch.equal(got_s[m][k], want_s[m][k]), (m, k)
    _unwritten(raw, state, kept)


def test_adam_kernel_ten_steps_and_a_reset(card):
    """Ten steps on the card against the plain version, with an opacity
    moment reset between (a new state dict holding fresh zeros); fresh
    gradients each step on one cached plan; a densify step on the outputs
    (the raw tensors as autograd leaves first, then the rows rewritten) and
    a capacity change, which takes a new plan; the inputs of every step
    unwritten."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam
    from openglgaussiansplattingrenderer_tpu_torch.train import densify

    n = 9_999
    raw, grads, _ = _adam_case(n, 5, card, sh=True)
    opt = trainer.make_optimizer(trainer.TrainConfig(lr_means_final=1e-6), tuple(raw))
    state = plain = opt.init(raw)
    p, q = raw, raw
    plans = []
    for i in range(10):
        g = {k: v * (1.0 + 0.1 * i) for k, v in grads.items()}
        lrs = {k: opt.learning_rate(k, plain["count"]) for k in raw}
        plans.append(kadam.plan(g, state, lrs, p)[0])
        kept = _kept(p, state)
        p2, state2 = opt.update(g, state, p)
        _unwritten(p, state, kept)
        p, state = p2, state2
        u, plain = kadam.adam_update_plain(g, plain, lrs)
        q = {k: q[k] + u[k] for k in raw}
        if i == 4:
            state = densify.reset_opacity_moments(state, n)
            plain = densify.reset_opacity_moments(plain, n)
        if i == 6:
            # the outputs as autograd leaves, then a densify step at a
            # larger capacity: pad (cat), prune, clone and split (gathers
            # and index writes), moments of changed rows zeroed
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            sum((x * x).sum() for x in leaves.values()).backward()
            for k in raw:
                assert torch.equal(leaves[k].grad, 2 * p[k]), k
            cap = n + 1_001
            dc = densify.DensifyConfig(capacity=cap, grad_threshold=1e-4)
            accum = torch.linspace(0, 1e-3, cap, device=card)
            seen = torch.ones(cap, device=card)
            normals = densify.split_normals(cap, torch.Generator(card).manual_seed(1), card)
            out = []
            for r, st in ((p, state), (q, plain)):
                padded, alive = densify.pad_to_capacity(r, cap)
                st = {"count": st["count"], **{m: {k: torch.cat(
                    [v, v.new_zeros((cap - n,) + v.shape[1:])]) for k, v in st[m].items()}
                    for m in ("mu", "nu")}}
                r2, _, changed, _ = densify.densify_and_prune(padded, alive, accum, seen, dc,
                                                              normals=normals)
                out.append((r2, densify.reset_rows(st, changed)))
            (p, state), (q, plain) = out
            grads = {k: torch.cat([v, v[: cap - n]]) for k, v in grads.items()}
    # fresh gradients each step: one plan until the capacity changed
    assert plans[1] is plans[2] is plans[6] and plans[7] is plans[9] is not plans[6]
    for k in raw:
        assert torch.equal(p[k], q[k]), k
        assert torch.equal(state["nu"][k], plain["nu"][k]), k
        assert torch.equal(state["mu"][k], plain["mu"][k]), k


LOSS_CARD_SHAPES = [(40, 52, 3), (11, 11, 3), (11, 64, 3), (64, 11, 3), (2, 24, 24, 3),
                    (33, 47, 1), (17, 100, 3), (512, 1024, 3), (3, 61, 35, 3), (37, 70, 3),
                    (2, 45, 75, 3), (30, 40, 6)]


def _loss_images(shape, seed, card, strided=True):
    """(pred, target) on the card: pred the first channels of a wider image
    (the rendered image's layout), flat in part (E[p^2] - mu^2 cancels)."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(shape[:-1] + (shape[-1] + 1,), generator=g)
    img[..., : shape[-3] // 3, :, :] = 0.5
    target = (img[..., : shape[-1]] + 0.1 * torch.randn(shape, generator=g)).clamp(0, 1)
    img, target = img.to(card), target.to(card)
    pred = img[..., : shape[-1]] if strided else img[..., : shape[-1]].contiguous()
    return pred, target


def _conv_loss_f64(pred, target, lam, monkeypatch):
    """(loss, gradient) of the conv form (``losses.gs_loss_plain``) taken in
    float64 with autograd: its window cast to double."""
    from openglgaussiansplattingrenderer_tpu_torch.train import losses

    window = losses._gaussian_window
    with monkeypatch.context() as m:
        m.setattr(losses, "_gaussian_window", lambda *a, **k: window(*a, **k).double())
        x = pred.detach().double().requires_grad_(True)
        loss = losses.gs_loss_plain(x, target.double(), lam)
        (grad,) = torch.autograd.grad(loss, x)
    return float(loss), grad


@pytest.mark.parametrize("shape", LOSS_CARD_SHAPES)
def test_gs_loss_kernels_match_separable_plain_and_conv(card, shape, monkeypatch):
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl
    from openglgaussiansplattingrenderer_tpu_torch.train import losses

    pred, target = _loss_images(shape, sum(shape), card)
    x = pred.detach().requires_grad_(True)
    before = (kl.gs_loss_fwd.launches, kl.gs_loss_bwd.launches)
    loss = losses.gs_loss(x, target, 0.2)
    (grad,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    # the forward is two launches: the tiles, then the sum of their slots
    assert (kl.gs_loss_fwd.launches, kl.gs_loss_bwd.launches) == (before[0] + 2, before[1] + 1)
    assert grad.shape == pred.shape
    lv = float(loss.detach())
    want = kl.gs_loss_separable_plain(pred, target, 0.2)
    want_g = kl.gs_loss_separable_bwd_plain(pred, target, torch.ones((), device=card), 0.2)
    assert abs(lv - float(want)) <= 1e-7 * abs(float(want))
    assert float((grad - want_g).abs().max()) <= 1e-6 * float(want_g.abs().max())
    # the conv form's loss; its gradient in float64 (the float32 conv form's
    # own gradient lies up to 3e-5 of the largest from that, in flat regions)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        cv = float(losses.gs_loss_plain(pred, target, 0.2))
    assert abs(lv - cv) <= 1e-6 * max(1.0, abs(cv))
    v64, g64 = _conv_loss_f64(pred, target, 0.2, monkeypatch)
    assert abs(lv - v64) <= 1e-6 * max(1.0, abs(v64))
    assert float((grad.double() - g64).abs().max()) <= 1e-5 * float(g64.abs().max())


@pytest.mark.parametrize("shape", [(37, 70, 3), (2, 45, 75, 3), (29, 35, 2), (40, 64, 3)])
@pytest.mark.parametrize("layout", ["frame view", "contiguous", "unaligned offset"])
def test_gs_loss_kernels_stage_either_path(card, shape, layout):
    """pred 16 bytes a pixel (the rendered (..., H, W, 4) frame's view) or 4
    bytes an element (a contiguous copy; a view one float off 16 bytes):
    the same bits, held to the separable restatement; target's rows 16
    bytes a copy where a row's floats end on 16 bytes (40 x 64), else 4
    bytes an element."""
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl
    from openglgaussiansplattingrenderer_tpu_torch.train import losses

    pred, target = _loss_images(shape, sum(shape) + 1, card)
    c = shape[-1]
    if layout == "frame view":          # an (..., H, W, 4) frame's first channels
        wide = torch.zeros(shape[:-1] + (4,), device=card)
        wide[..., :c] = pred
        pred = wide[..., :c]
    elif layout == "contiguous":
        pred = pred.contiguous()
    else:
        wide = torch.zeros(shape[:-1] + (c + 1,), device=card)
        wide[..., 1:] = pred
        pred = wide[..., 1:]
    assert kl.stages_whole_pixels(pred) is (layout == "frame view")
    assert kl.stages_rows(target) is (shape[-2] * c % 4 == 0)
    x = pred.detach().requires_grad_(True)
    before = (kl.gs_loss_fwd.launches, kl.gs_loss_bwd.launches)
    loss = losses.gs_loss(x, target, 0.2)
    (grad,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    assert (kl.gs_loss_fwd.launches, kl.gs_loss_bwd.launches) == (before[0] + 2, before[1] + 1)
    want = kl.gs_loss_separable_plain(pred, target, 0.2)
    want_g = kl.gs_loss_separable_bwd_plain(pred, target, torch.ones((), device=card), 0.2)
    assert abs(float(loss) - float(want)) <= 1e-7 * abs(float(want))
    assert float((grad - want_g).abs().max()) <= 1e-6 * float(want_g.abs().max())
    # the other path's bits: the staging moves the same floats
    other = pred.contiguous() if layout == "frame view" else torch.zeros(
        shape[:-1] + (4,), device=card)
    if layout != "frame view":
        other[..., :c] = pred
        other = other[..., :c]
    assert kl.stages_whole_pixels(other) is (layout != "frame view")
    y = other.detach().requires_grad_(True)
    again = losses.gs_loss(y, target, 0.2)
    assert torch.equal(again, loss)
    assert torch.equal(torch.autograd.grad(again, y)[0], grad)


def test_gs_loss_kernels_repeat_and_take_a_cotangent(card):
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl
    from openglgaussiansplattingrenderer_tpu_torch.train import losses

    pred, target = _loss_images((100, 130, 3), 3, card)
    x = pred.detach().requires_grad_(True)
    runs = []
    for _ in range(3):
        loss = losses.gs_loss(x, target, 0.3)
        runs.append((loss.detach(), torch.autograd.grad(3.0 * loss, x)[0]))
    for loss, grad in runs[1:]:
        assert torch.equal(loss, runs[0][0]) and torch.equal(grad, runs[0][1])
    want = kl.gs_loss_separable_bwd_plain(pred, target, torch.full((), 3.0, device=card), 0.3)
    assert float((runs[0][1] - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # the contiguous copy of pred gives the same bits as the strided view
    flat = pred.contiguous()
    assert torch.equal(losses.gs_loss(flat, target, 0.3), runs[0][0])
    with pytest.raises(RuntimeError):
        loss = losses.gs_loss(x, target, 0.3)
        (g,) = torch.autograd.grad(loss, x, create_graph=True)
        torch.autograd.grad(g.sum(), x)
    with pytest.raises(ValueError):
        losses.gs_loss(x, target.cpu(), 0.3)


def test_train_step_launches_adam_and_the_loss_once(card):
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import adam as kadam
    from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import ssim_loss as kl

    w = h = 64
    scene = {k: v for k, v in ply_io.make_synthetic_scene(40, seed=8, extent=1.2).items()
             if k != "sh_rest"}
    cam = port.Camera(0.0, 0.0, -4.0, width=w, height=h)
    cfg = port.RenderConfig(chunk=32, dup_capacity_factor=32.0)
    params = convert.params_from_numpy(scene, card)
    target = render_stats(params, cam, cfg)[0][..., :3].contiguous()
    step = trainer.make_train_step(cfg, trainer.TrainConfig(), w, h, with_grad_norms=True)
    state = step.init(trainer.raw_from_params(dict(params, colors=params["colors"] * 0.8)))
    bundle = trainer.camera_bundles([cam], card)[0]
    before = (kadam.adam_update.launches, kl.gs_loss_fwd.launches, kl.gs_loss_bwd.launches)
    for _ in range(3):
        state, metrics = step(state, target, *bundle)
    assert (kadam.adam_update.launches, kl.gs_loss_fwd.launches,
            kl.gs_loss_bwd.launches) == tuple(b + 3 * n for b, n in zip(before, (1, 2, 1)))
    assert state.opt_state["count"] == 3 and bool(torch.isfinite(metrics["loss"]))


def _orbit_scene(card, sh_degree=3, n=3000, w=160, h=96):
    """A small clustered scene at SH 3, its frame's arguments a pose, and a
    config with the capacity pinned: what a viewer renders."""
    scene = ply_io.make_clustered_scene(n, seed=11, extent=1.5)
    params = convert.params_from_numpy(scene, card)
    cfg = port.RenderConfig.for_resolution(w, h, tile_px=16, chunk=64, sh_degree=sh_degree,
                                           capacity_records=1 << 16,
                                           background=(0.1, 0.2, 0.3))

    def pose(i):
        cam = port.Camera(0.0, 0.0, -5.0, width=w, height=h)
        cam.rotation[1] = 1.5 * i
        cam.position[0] = 0.3 * np.sin(0.3 * i)
        cam.update()
        a = port.camera_args(cam)
        return (a["view"], a["vp"], a["focal_x"], a["focal_y"], a["tan_fovx"], a["tan_fovy"],
                w, h)

    return params, cfg, pose


def _eager_frame(params, args, cfg):
    from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath

    view, vp = (torch.as_tensor(m, dtype=torch.float32, device=params["means"].device)
                for m in args[:2])
    return fastpath.render_fast(params, view, vp, *args[2:], cfg)


def _launches():
    from openglgaussiansplattingrenderer_tpu_torch import frame_graph

    return {f.__qualname__: f.launches for f in frame_graph.launch_counters()}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def test_an_eager_frame_and_a_train_step_make_no_synchronising_call(card):
    params, cfg, pose = _orbit_scene(card)
    w, h = pose(0)[6:]
    target = render_arrays(params, *pose(5), cfg)[0][..., :3].contiguous()
    step = trainer.make_train_step(cfg, trainer.TrainConfig(), w, h, param_keys=(
        "means", "log_scales", "quats", "logit_opacities", "colors", "sh_rest"))
    state = step.init(trainer.raw_from_params(params))
    bundle = trainer.camera_bundles([port.Camera(0.3, 0.0, -5.0, width=w, height=h)], card)[0]
    state, _ = step(state, target, *bundle)         # first calls: plans, constants, the ring
    torch.cuda.synchronize()
    frame_graphs.clear()                            # the next frame is a key's first: eager
    eager, replays = render_arrays.eager, render_arrays.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, stats = render_arrays(params, *pose(1), cfg)
        state, metrics = step(state, target, *bundle)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the frame and the step's frame, both eager
    assert (render_arrays.eager, render_arrays.replays) == (eager + 2, replays)
    want = _eager_frame(params, pose(1), cfg)
    assert torch.equal(img, want[0]) and torch.equal(stats["num_records"], want[1]["num_records"])
    assert bool(torch.isfinite(metrics["loss"]))


@pytest.mark.parametrize("matrices", ["numpy", "on_the_card"])
def test_graph_frames_over_an_orbit_are_bit_equal_to_eager_frames(card, matrices):
    from openglgaussiansplattingrenderer_tpu_torch import frame_graph

    params, cfg, host_pose = _orbit_scene(card)

    def pose(i):
        a = host_pose(i)
        if matrices == "numpy":             # the graph copies them in itself
            return a
        return tuple(torch.as_tensor(m, device=card) for m in a[:2]) + a[2:]

    counter = types.SimpleNamespace(captures=0, replays=0, eager=0, capture_failures=0)
    fg = frame_graph.FrameGraphs(counter)
    before = _launches()
    _eager_frame(params, pose(0), cfg)
    torch.cuda.synchronize()
    eager_launches = _delta(_launches(), before)
    assert eager_launches
    kept, per_frame = [], []
    with torch.no_grad():
        for i in range(20):
            before = _launches()
            img, stats = fg.render(params, *pose(i), cfg)
            per_frame.append(_delta(_launches(), before))
            want_img, want_stats = _eager_frame(params, pose(i), cfg)
            assert torch.equal(img, want_img), i
            assert int(want_stats["num_records"]) > 0 and int(want_stats["overflow"]) == 0, i
            assert list(stats) == list(want_stats)
            for k, v in want_stats.items():
                assert stats[k].dtype == v.dtype and torch.equal(stats[k], v), (i, k)
            if kept:        # frame k is unchanged after frame k + 1
                assert torch.equal(kept[-1][0], kept[-1][1]), i - 1
            kept.append((img, img.clone()))
    assert (counter.eager, counter.captures, counter.replays, counter.capture_failures) == \
        (1, 1, 19, 0), fg.last_error
    # an eager frame's launches; the capture frame's warm-up and replay; each replay
    assert per_frame[0] == eager_launches
    assert per_frame[1] == {k: 2 * v for k, v in eager_launches.items()}
    assert all(d == eager_launches for d in per_frame[2:])


def test_graph_frames_show_an_in_place_edit_of_the_parameters(card):
    from openglgaussiansplattingrenderer_tpu_torch import frame_graph

    params, cfg, pose = _orbit_scene(card, sh_degree=0)
    params = {k: v for k, v in params.items() if k != "sh_rest"}
    counter = types.SimpleNamespace(captures=0, replays=0, eager=0, capture_failures=0)
    fg = frame_graph.FrameGraphs(counter)
    for i in range(3):
        fg.render(params, *pose(i), cfg)
    with torch.no_grad():
        params["colors"].mul_(0.5)
        params["means"][:, 0].add_(0.25)
    img, stats = fg.render(params, *pose(3), cfg)
    want_img, want_stats = _eager_frame(params, pose(3), cfg)
    assert torch.equal(img, want_img)
    assert all(torch.equal(stats[k], v) for k, v in want_stats.items())
    assert (counter.captures, counter.replays, counter.capture_failures) == (1, 3, 0)
