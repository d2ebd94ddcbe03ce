"""The training loss (1 - lambda) L1 + lambda D-SSIM and its backward.

The JAX package takes D-SSIM with XLA's depthwise convolutions
(``train/losses.py`` ``ssim_map``) and its gradient by autodiff; no Pallas
kernel. The kernels are ``csrc/ssim_loss.cu``: the forward (``gs_loss_fwd``,
two launches: the five windowed sums taken separably with the normalised
1-D Gaussian over a tile staged with its halo in shared memory, the SSIM
map, the three partials the backward needs and the L1 terms, a block's sums
to its slot; then one block adds the slots in index order) and the backward (``gs_loss_bwd``, one
launch: the partials through the transposed, "full" window sum, the L1
sign). ``GsLoss`` is the autograd function of the two; ``train/losses.py``
``gs_loss`` runs it on CUDA tensors. Images are (H, W, C) or (B, H, W, C),
H and W at least 11, float32, at any strides: the kernels read the rendered
image's first three channels in place.

``gs_loss_separable_plain`` and ``gs_loss_separable_bwd_plain`` restate the
kernels' arithmetic in torch, expression for expression: the CPU tests hold
them against the JAX package, the card holds the kernels against them. The
VALID window sum of the map is the depthwise convolution of ``ssim_map``,
taken along the rows, then down the columns; its transpose is the same
Gaussian over the partials padded by 10 zeros a side (the Gaussian is
symmetric, bit for bit). Past the float32 inputs both run in float64 (the
partials the forward stores too) and round the loss and the gradient to
float32 once: E[p^2] - mu^2 cancels in flat regions, and the backward's
three window sums cancel against each other there, so float32 arithmetic
leaves the gradient some 1e-5 of its largest from its float64 value on a
rendered frame, as the float32 conv form does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

WINDOW, SIGMA = 11, 1.5            # ssim_map's Gaussian window
HALO = WINDOW - 1
C1, C2 = 0.01 ** 2, 0.03 ** 2


class LossArgs(ctypes.Structure):
    """The loss's scalars, shape and strides as ``csrc/ssim_loss.cu`` reads
    them (strides in elements: batch, row, column, channel)."""
    _fields_ = [("g", ctypes.c_double * WINDOW)] + [
        (name, ctypes.c_double) for name in ("c1", "c2", "coef_ssim", "coef_l1", "lam")] + [
        (name, ctypes.c_int) for name in ("b", "h", "w", "c")] + [
        ("ps", ctypes.c_longlong * 4), ("ts", ctypes.c_longlong * 4)]


@functools.lru_cache(maxsize=1)
def _library():
    """(the kernel library, a block's tile width and height), once
    ``LossArgs`` is checked against the kernel's layout."""
    lib = build.load_library()
    if lib.gs_loss_args_size() != ctypes.sizeof(LossArgs):
        raise RuntimeError(f"ssim_loss: the kernel's LossArgs has "
                           f"{lib.gs_loss_args_size()} bytes, LossArgs "
                           f"{ctypes.sizeof(LossArgs)}")
    return lib, lib.gs_loss_tile_w(), lib.gs_loss_tile_h()


@functools.lru_cache(maxsize=1)
def gaussian_1d() -> Tuple[float, ...]:
    """The normalised 1-D Gaussian whose outer product is ``ssim_map``'s
    window, in float32 on the CPU as ``losses._gaussian_window`` takes it."""
    x = torch.arange(WINDOW, dtype=torch.float32) - (WINDOW - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * SIGMA ** 2))
    return tuple(float(v) for v in g / torch.sum(g))


def check_inputs(pred: torch.Tensor, target: torch.Tensor) -> bool:
    """What both routes need of the loss's inputs; True where the kernels
    run (every input on one CUDA device), False on the CPU. Raises on
    another dtype than float32, unequal shapes, images under 11 x 11 and
    inputs on mixed devices."""
    for name, t in (("pred", pred), ("target", target)):
        if t.dtype != torch.float32:
            raise TypeError(f"gs_loss: {name} must be float32, got {t.dtype}")
    if pred.shape != target.shape or pred.dim() not in (3, 4):
        raise ValueError(f"gs_loss: pred {tuple(pred.shape)} and target "
                         f"{tuple(target.shape)} must be one (H, W, C) or (B, H, W, C) shape")
    h, w = pred.shape[-3], pred.shape[-2]
    if h < WINDOW or w < WINDOW:
        raise ValueError(f"gs_loss: images must be at least {WINDOW} x {WINDOW}, "
                         f"got {h} x {w}")
    return build.on_cuda("gs_loss", pred, target, has_backward=True)


# ---- the plain restatement --------------------------------------------------

def _along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The VALID 11-tap Gaussian sum along ``dim``, tap after tap."""
    g = gaussian_1d()
    n = x.shape[dim] - HALO
    s = g[0] * x.narrow(dim, 0, n)
    for k in range(1, WINDOW):
        s = s + g[k] * x.narrow(dim, k, n)
    return s


def _window(x: torch.Tensor) -> torch.Tensor:
    """The VALID 11 x 11 window sums of (..., H, W, C): along the rows,
    then down the columns."""
    return _along(_along(x, -2), -3)


def ssim_terms(pred: torch.Tensor, target: torch.Tensor):
    """(SSIM map, (dS/dE[p], dS/dE[p^2], dS/dE[pt])) over the VALID windows,
    each (..., H - 10, W - 10, C) in float64, as the forward kernel computes
    them."""
    pred, target = pred.double(), target.double()
    mu_p, mu_t = _window(pred), _window(target)
    e_pp, e_tt, e_pt = _window(pred * pred), _window(target * target), _window(pred * target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p, sig_t, sig_pt = e_pp - mu_pp, e_tt - mu_tt, e_pt - mu_pt
    a1, a2 = 2 * mu_pt + C1, 2 * sig_pt + C2
    b1, b2 = mu_pp + mu_tt + C1, sig_p + sig_t + C2
    d = b1 * b2
    s = (a1 * a2) / d
    d_mu = 2 * (mu_t * (a2 - a1) - s * mu_p * (b2 - b1)) / d
    return s, (d_mu, -s / b2, (2 * a1) / d)


def gs_loss_separable_plain(pred: torch.Tensor, target: torch.Tensor,
                            lambda_dssim: float = 0.2) -> torch.Tensor:
    """The forward kernel's loss in torch (no autograd graph): the SSIM map
    of separable window sums and the two means in float64, rounded to
    float32 once."""
    s, _ = ssim_terms(pred, target)
    l1 = (pred - target).abs().double().sum() / pred.numel()
    ssim = s.sum() / s.numel()
    return ((1.0 - lambda_dssim) * l1 + lambda_dssim * ((1.0 - ssim) / 2.0)).float()


def gs_loss_separable_bwd_plain(pred: torch.Tensor, target: torch.Tensor,
                                dloss: torch.Tensor,
                                lambda_dssim: float = 0.2) -> torch.Tensor:
    """The backward kernel in torch: dL/dpred of ``gs_loss_separable_plain``
    for the cotangent ``dloss`` (0-d), the partials through the full window
    sum in float64, rounded to float32 once."""
    s, partials = ssim_terms(pred, target)
    full = [_window(F.pad(d, (0, 0, HALO, HALO, HALO, HALO))) for d in partials]
    dloss = dloss.double()
    s_ssim = (-lambda_dssim / (2 * s.numel())) * dloss
    s_l1 = ((1.0 - lambda_dssim) / pred.numel()) * dloss
    br = full[0] + 2 * pred.double() * full[1] + target.double() * full[2]
    return (s_ssim * br + s_l1 * torch.sign(pred - target).double()).float()


# ---- the kernels --------------------------------------------------------------

def _as4(t: torch.Tensor) -> torch.Tensor:
    return t if t.dim() == 4 else t.unsqueeze(0)


def loss_args(pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float) -> LossArgs:
    """The kernels' arguments for (B, H, W, C) or (H, W, C) images; the
    coefficients in double, as the plain restatement takes them."""
    p4, t4 = _as4(pred), _as4(target)
    b, h, w, c = p4.shape
    m = b * (h - HALO) * (w - HALO) * c
    return LossArgs(g=gaussian_1d(), c1=C1, c2=C2,
                    coef_ssim=-lambda_dssim / (2 * m),
                    coef_l1=(1.0 - lambda_dssim) / (b * h * w * c),
                    b=b, h=h, w=w, c=c, lam=lambda_dssim,
                    ps=tuple(p4.stride()), ts=tuple(t4.stride()))


def gs_loss_fwd(pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels on CUDA inputs that passed ``check_inputs`` (two
    launches): (the loss, 0-d, and the partials the backward reads, (3, B C,
    H - 10, W - 10) float64)."""
    lib, tw, th = _library()
    args = loss_args(pred, target, lambda_dssim)
    blocks = -(-args.w // tw) * -(-args.h // th) * args.b * args.c
    dev = pred.device
    parts = torch.empty((3, args.b * args.c, args.h - HALO, args.w - HALO),
                        dtype=torch.float64, device=dev)
    slots = torch.empty((blocks, 2), dtype=torch.float64, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    build.check("gs_loss", lib.gs_loss_forward(
        pred.data_ptr(), target.data_ptr(), ctypes.addressof(args), parts.data_ptr(),
        slots.data_ptr(), loss.data_ptr(), build.stream_ptr()))
    gs_loss_fwd.launches += 2
    return loss, parts


def gs_loss_bwd(pred: torch.Tensor, target: torch.Tensor, parts: torch.Tensor,
                dloss: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """The backward kernel: dL/dpred (pred's shape, contiguous) from the
    forward's partials and the loss's cotangent ``dloss`` (0-d, read on
    the device)."""
    lib, _, _ = _library()
    args = loss_args(pred, target, lambda_dssim)
    build.expect("gs_loss_bwd", parts, torch.float64,
                 (3, args.b * args.c, args.h - HALO, args.w - HALO))
    dloss = dloss.to(torch.float32).contiguous()
    out = torch.empty(pred.shape, dtype=torch.float32, device=pred.device)
    build.check("gs_loss_bwd", lib.gs_loss_backward(
        pred.data_ptr(), target.data_ptr(), ctypes.addressof(args), parts.data_ptr(),
        dloss.data_ptr(), out.data_ptr(), build.stream_ptr()))
    gs_loss_bwd.launches += 1
    return out


gs_loss_fwd.launches = 0
gs_loss_bwd.launches = 0


class GsLoss(torch.autograd.Function):
    """The loss on CUDA images: forward and backward kernels, no float
    atomics (the loss and its gradient repeat bit for bit). ``target`` gets
    no gradient; a second derivative raises."""

    @staticmethod
    def forward(ctx, pred, target, lambda_dssim):
        loss, parts = gs_loss_fwd(pred, target, lambda_dssim)
        ctx.save_for_backward(pred, target, parts)
        ctx.lambda_dssim = lambda_dssim
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, dloss):
        pred, target, parts = ctx.saved_tensors
        return gs_loss_bwd(pred, target, parts, dloss, ctx.lambda_dssim), None, None
