"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere (the fixture
decides, at run time). They import nothing of JAX; on a machine with a
card run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

They cover what ``chip_smoke.py``'s flagship shapes do not: every
pixels-per-thread variant of the compositor, pixels past the tile, empty
tiles, a batch above the default 48 KB of shared memory, overflow in the
segment sum, run-to-run equality, training on the card, the radix-sort
kernels at ragged sizes and both digit widths, the single-key sort paths
of the frame, and the two probe kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import radix_sort as rx
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.probes import bucketer_probe, cache_key_probe
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays, render_stats
from openglgaussiansplattingrenderer_tpu_torch.train import trainer

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
    (32, 32, 1024)])
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
    assert kr.segsum.launches == before + 1
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    assert float(((got - ref).abs() / scale).max()) <= 1e-5
    assert not got[:, (counts == 0).to(card)].any()
    assert torch.equal(got, kr.segsum(cot, cum))
    assert kr.segsum(cot, cum[:0]).shape == (9, 0)


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


def _u32_keys(n, seed, hi=2 ** 32):
    keys = np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint32)
    return torch.from_numpy(keys.view(np.int32))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n,nv", [(1, 1), (4096, 0), (5000, 3), (300_001, 9)])
def test_radix_kernels_match_plain(card, bits, n, nv):
    # every pass of a 32-bit sort: counts and placement equal the plain
    # versions exactly, ragged last chunk included
    k = _u32_keys(n, n + bits).to(card)
    v = torch.arange(nv * n, dtype=torch.int32, device=card).view(nv, n)
    h0, s0 = rx.radix_hist.launches, rx.radix_scatter.launches
    for p in range(32 // bits):
        counts = rx.radix_hist(k, p * bits, bits)
        assert torch.equal(counts, rx.radix_hist_plain(k, p * bits, bits))
        offs = rx._prefix_offsets(counts)
        got = rx.radix_scatter(k, v, offs, p * bits, bits)
        ref = rx.radix_scatter_plain(k, v, offs, p * bits, bits)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        k, v = got
    torch.cuda.synchronize()
    assert (rx.radix_hist.launches, rx.radix_scatter.launches) == (
        h0 + 32 // bits, s0 + 32 // bits)
    assert bool((kr.u32_values(k).diff() >= 0).all())


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
    h0 = rx.radix_hist.launches
    with torch.no_grad():
        img, stats = render_arrays(on_card, *args, cfg)
        used = rx.radix_hist.launches - h0
        img_like, _ = render_arrays(on_card, *args, like)
        img_cpu, stats_cpu = render_arrays(on_cpu, *args, cfg)
    assert used == (0 if cfg.record_sort == "lax" else 4 if name.startswith("packed") else 2)
    assert torch.equal(img, img_like)            # the engine does not show
    assert float((img.cpu() - img_cpu).abs().max()) <= 1e-4
    assert all(stats[k].item() == stats_cpu[k].item() for k in stats_cpu)
    g_card, g_cpu = _grads(on_card, args, cfg), _grads(on_cpu, args, cfg)
    for k, want in g_cpu.items():
        err = float((g_card[k].cpu() - want).abs().max() / want.abs().max())
        assert err <= 5e-3, (k, err)


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


@pytest.mark.parametrize("shape", [(0,), (1,), (8, 128), (1_000_003,)])
def test_probe_affine_matches_plain(card, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(card)
    before = cache_key_probe.probe_affine.launches
    got = cache_key_probe.probe_affine(x)
    assert cache_key_probe.probe_affine.launches == before + (x.numel() > 0)
    assert torch.equal(got, cache_key_probe.probe_affine_plain(x))
