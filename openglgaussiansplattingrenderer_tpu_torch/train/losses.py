"""Image losses for splat fitting.

Counterpart of ``openglgaussiansplattingrenderer_tpu/train/losses.py``:
L1 + D-SSIM, the standard 3DGS training loss (Kerbl et al. sec. 5). Images
are (..., H, W, C) as in the JAX package; the windowed statistics permute
to PyTorch's channel-first layout inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim_map(pred: torch.Tensor, target: torch.Tensor, c1: float = 0.01 ** 2,
             c2: float = 0.03 ** 2) -> torch.Tensor:
    """Per-window SSIM map over (..., H, W, C) images: VALID 11x11 Gaussian
    windows -> (..., H-10, W-10, C). ``ssim`` is this map's mean.

    The depthwise convolution runs in full float32: on a CUDA device cuDNN
    would take TF32 for a float32 convolution by default, so it is switched
    off around the call (the JAX package asks for ``precision="highest"``).
    """
    win = _gaussian_window(device=pred.device)

    def filt(x):
        x4 = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)   # (B,C,H,W)
        c = x4.shape[1]
        w = win[None, None].expand(c, 1, -1, -1)
        with torch.backends.cudnn.flags(allow_tf32=False):
            y = F.conv2d(x4, w, groups=c)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(x.shape[:-3] + y.shape[-3:])

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p = filt(pred * pred) - mu_pp
    sig_t = filt(target * target) - mu_tt
    sig_pt = filt(pred * target) - mu_pt
    return ((2 * mu_pt + c1) * (2 * sig_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2))


def ssim(pred: torch.Tensor, target: torch.Tensor, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """SSIM over (H, W, C) images in [0, 1], 11x11 Gaussian window."""
    return torch.mean(ssim_map(pred, target, c1, c2))


def dssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (1.0 - ssim(pred, target)) / 2.0


def gs_loss(pred: torch.Tensor, target: torch.Tensor,
            lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - lambda)*L1 + lambda*D-SSIM, the 3DGS paper's training loss."""
    return (1.0 - lambda_dssim) * l1(pred, target) + lambda_dssim * dssim(pred, target)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
