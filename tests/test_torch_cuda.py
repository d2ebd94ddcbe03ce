"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere (the fixture
decides, at run time). They import nothing of JAX; on a machine with a
card run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

They cover what ``chip_smoke.py``'s flagship shapes do not: every
pixels-per-thread variant of the compositor, pixels past the tile, empty
tiles, a batch above the default 48 KB of shared memory, overflow in the
segment sum, run-to-run equality, and training on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import openglgaussiansplattingrenderer_tpu_torch as port
from openglgaussiansplattingrenderer_tpu_torch import convert
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import composite as kc
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
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
