"""The training loss (1 - lambda) L1 + lambda D-SSIM and its backward.

The JAX package takes D-SSIM with XLA's depthwise convolutions
(``train/losses.py`` ``ssim_map``) and its gradient by autodiff; no Pallas
kernel. The kernels are ``csrc/ssim_loss.cu``: the forward (``gs_loss_fwd``,
two launches: a block walks a 32-column strip of an image down, every
channel at once, staging 8 rows at a time by ``cp.async`` while it sums the
rows before, and takes the four windowed sums the map needs separably with
the normalised 1-D Gaussian, the SSIM map, the three partials the backward
needs and the L1 terms, a block's sums to its slot; then one block adds the
slots in index order) and the backward (``gs_loss_bwd``, one launch of the
same shape: the partials through the transposed, "full" window sum, the L1
sign). ``GsLoss`` is the autograd function of the two; ``train/losses.py``
``gs_loss`` runs it on CUDA tensors. Images are (H, W, C) or (B, H, W, C),
H and W at least 11, float32, at any strides: the kernels read the rendered
image's first three channels in place, a pixel in one 16-byte copy where
``stages_whole_pixels`` says so, and the target's rows 16 bytes a copy where
``stages_rows`` says so. ``plan`` keeps each shape's arguments, made once.

``gs_loss_separable_plain`` and ``gs_loss_separable_bwd_plain`` restate the
kernels' arithmetic in torch, expression for expression: the CPU tests hold
them against the JAX package, the card holds the kernels against them. The
VALID window sum of the map is the depthwise convolution of ``ssim_map``,
taken along the rows, then down the columns; its transpose is the same
Gaussian over the partials padded by 10 zeros a side (the Gaussian is
symmetric, bit for bit). Past the float32 inputs both run in float64 and
round the loss and the gradient to float32 once; the partials between the
two kernels are stored as ``PARTIAL_DTYPE`` (float32) and summed in float64.
float64 sums matter: E[p^2] - mu^2 cancels in flat regions, and the
backward's three window sums cancel against each other there, so float32
arithmetic leaves the gradient some 1e-5 of its largest from its float64
value on a rendered frame, as the float32 conv form does. One difference in
rounding is left: the kernels take each tap of a window sum as one fused
multiply-add, ``fma(g, x, s)``, where torch rounds ``g * x`` and the sum
apart (the card holds the two at 1e-7 of the loss and 1e-6 of the largest
gradient).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.utils.timing import span

WINDOW, SIGMA = 11, 1.5            # ssim_map's Gaussian window
HALO = WINDOW - 1
C1, C2 = 0.01 ** 2, 0.03 ** 2
PARTIAL_DTYPE = torch.float32      # csrc/ssim_loss.cu GS_LOSS_PART_T
PIXELS, ROWS = 1, 2                # csrc/ssim_loss.cu kPixels, kRows: the staging modes


class LossArgs(ctypes.Structure):
    """The loss's scalars, shape, strides and staging paths as
    ``csrc/ssim_loss.cu`` reads them (strides in elements: batch, row,
    column, channel); ``gs_loss_plan`` fills the channel groups and the
    segments."""
    _fields_ = [("g", ctypes.c_double * WINDOW)] + [
        (name, ctypes.c_double) for name in ("c1", "c2", "coef_ssim", "coef_l1", "lam")] + [
        (name, ctypes.c_int) for name in ("b", "h", "w", "c")] + [
        ("ps", ctypes.c_longlong * 4), ("ts", ctypes.c_longlong * 4)] + [
        (name, ctypes.c_int) for name in (
            "pvec", "tvec", "cg", "groups", "fseg", "fsegs", "bseg", "bsegs")]


@functools.lru_cache(maxsize=1)
def _library():
    """(the kernel library, the partials' dtype), once ``LossArgs`` is
    checked against the kernel's layout."""
    lib = build.load_library()
    if lib.gs_loss_args_size() != ctypes.sizeof(LossArgs):
        raise RuntimeError(f"ssim_loss: the kernel's LossArgs has "
                           f"{lib.gs_loss_args_size()} bytes, LossArgs "
                           f"{ctypes.sizeof(LossArgs)}")
    return lib, {4: torch.float32, 8: torch.float64}[lib.gs_loss_partial_bytes()]


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
    them: the map needs E[p^2] and E[t^2] only as their sum (the two
    variances meet only in sigma_p + sigma_t), so four window sums."""
    pred, target = pred.double(), target.double()
    mu_p, mu_t = _window(pred), _window(target)
    e_sq, e_pt = _window(pred * pred + target * target), _window(pred * target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    mu_sq = mu_pp + mu_tt
    a1, a2 = 2 * mu_pt + C1, 2 * (e_pt - mu_pt) + C2
    b1, b2 = mu_sq + C1, (e_sq - mu_sq) + C2
    r = 1.0 / (b1 * b2)
    s = (a1 * a2) * r
    d_mu = (2 * (mu_t * (a2 - a1) - s * mu_p * (b2 - b1))) * r
    return s, (d_mu, -(s * (b1 * r)), (2 * a1) * r)


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
    for the cotangent ``dloss`` (0-d): the partials, stored as
    ``PARTIAL_DTYPE``, through the full window sum in float64, rounded to
    float32 once."""
    s, partials = ssim_terms(pred, target)
    full = [_window(F.pad(d.to(PARTIAL_DTYPE).double(), (0, 0, HALO, HALO, HALO, HALO)))
            for d in partials]
    dloss = dloss.double()
    s_ssim = (-lambda_dssim / (2 * s.numel())) * dloss
    s_l1 = ((1.0 - lambda_dssim) / pred.numel()) * dloss
    br = full[0] + 2 * pred.double() * full[1] + target.double() * full[2]
    return (s_ssim * br + s_l1 * torch.sign(pred - target).double()).float()


# ---- the kernels --------------------------------------------------------------

def _dims4(shape, stride):
    """(B, H, W, C) and its strides of an (H, W, C) or (B, H, W, C) image."""
    if len(shape) == 3:
        return (1,) + tuple(shape), (shape[0] * stride[0],) + tuple(stride)
    return tuple(shape), tuple(stride)


def _whole_pixels(shape, stride, misalign: int, offset: int, nbytes: int) -> bool:
    (b, h, w, c), st = _dims4(shape, stride)
    if c > 4 or st[3] != 1 or st[2] != 4 or misalign:
        return False
    if (b > 1 and st[0] % 4) or (h > 1 and st[1] % 4):
        return False
    last = offset + (b - 1) * st[0] + (h - 1) * st[1] + (w - 1) * st[2]
    return (last + 4) * 4 <= nbytes


def _rows(shape, stride, misalign: int) -> bool:
    (b, h, w, c), st = _dims4(shape, stride)
    if c > 4 or st[3] != 1 or st[2] != c or (w * c) % 4 or misalign:
        return False
    return not ((b > 1 and st[0] % 4) or (h > 1 and st[1] % 4))


def stages_whole_pixels(t: torch.Tensor) -> bool:
    """Whether the kernels stage ``t``'s pixels 16 bytes at a time (one
    ``cp.async`` a pixel) rather than 4 bytes an element: at most 4
    channels, 1 float apart, pixels 4 floats apart (the rendered (H, W, 4)
    image), rows and images a multiple of 4 floats apart, 16-byte aligned,
    and the storage holding the last pixel's 16 bytes."""
    return _whole_pixels(t.shape, t.stride(), t.data_ptr() % 16, t.storage_offset(),
                         t.untyped_storage().nbytes())


def stages_rows(t: torch.Tensor) -> bool:
    """Whether the kernels stage ``t``'s rows as contiguous floats 16 bytes
    at a time rather than 4 bytes an element: at most 4 channels, 1 float
    apart, pixels C floats apart (a contiguous (..., H, W, C) image, as
    the target is), rows and images a multiple of 4 floats apart, a row's
    W C floats a multiple of 4, 16-byte aligned."""
    return _rows(t.shape, t.stride(), t.data_ptr() % 16)


def loss_args(pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float) -> LossArgs:
    """The kernels' arguments for (B, H, W, C) or (H, W, C) images, before
    ``gs_loss_plan``: the coefficients in double, as the plain restatement
    takes them, and each input's staging path."""
    return _loss_args(*_key(pred, target, lambda_dssim)[:-1])


def _key(pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float):
    """What a plan depends on, read off the tensors without a torch op:
    shape, strides, alignment and pred's storage (the staging paths),
    lambda and device."""
    return (pred.shape, pred.stride(), target.stride(), pred.data_ptr() % 16,
            pred.storage_offset(), pred.untyped_storage().nbytes(), target.data_ptr() % 16,
            lambda_dssim, pred.device)


def _loss_args(shape, ps, ts, pmis, poff, pbytes, tmis, lambda_dssim) -> LossArgs:
    (b, h, w, c), ps4 = _dims4(shape, ps)
    _, ts4 = _dims4(shape, ts)
    m = b * (h - HALO) * (w - HALO) * c
    return LossArgs(g=gaussian_1d(), c1=C1, c2=C2,
                    coef_ssim=-lambda_dssim / (2 * m),
                    coef_l1=(1.0 - lambda_dssim) / (b * h * w * c),
                    b=b, h=h, w=w, c=c, lam=lambda_dssim, ps=ps4, ts=ts4,
                    pvec=PIXELS if _whole_pixels(shape, ps, pmis, poff, pbytes) else 0,
                    tvec=ROWS if _rows(shape, ts, tmis) else 0)


def plan(pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float):
    """(the planned ``LossArgs``, its address, the forward's blocks, the
    forward's workspace in partials) for CUDA inputs: made once a key
    (``_key``), the kernels read the struct by address on every call."""
    return _plan(*_key(pred, target, lambda_dssim))


@functools.lru_cache(maxsize=64)
def _plan(*key):
    """``gs_loss_plan`` sizes the segments for the device's SMs."""
    lib, part_dtype = _library()
    args = _loss_args(*key[:-1])
    blocks = lib.gs_loss_plan(ctypes.addressof(args))
    if blocks < 0:
        build.check("gs_loss_plan", -blocks)
    n = 3 * args.b * (args.h - HALO) * (args.w - HALO) * 4 * args.groups
    return args, ctypes.addressof(args), blocks, workspace(n, part_dtype, blocks)


def workspace(n_parts: int, part_dtype: torch.dtype, blocks: int) -> Tuple[int, int]:
    """(the offset of the slots, the length in all) of the forward's one
    allocation, in partials: ``n_parts`` partials, then a slot of two
    doubles a block, 16-byte aligned (the kernels store and load a slot as
    one double2)."""
    per16 = 16 // part_dtype.itemsize
    start = -(-n_parts // per16) * per16
    return start, start + blocks * 16 // part_dtype.itemsize


def gs_loss_fwd(pred: torch.Tensor, target: torch.Tensor, lambda_dssim: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels on CUDA inputs that passed ``check_inputs`` (two
    launches): (the loss, 0-d, and the forward's workspace, which the
    backward reads: the partials, (3, B, H - 10, W - 10, 4 groups) of the
    library's partials' dtype, a pixel's group of up to 4 channels in 16
    bytes, the lanes past C zero; then the blocks' slots)."""
    lib, part_dtype = _library()
    _, addr, _, (start, total) = plan(pred, target, lambda_dssim)
    work = torch.empty(total, dtype=part_dtype, device=pred.device)
    loss = torch.empty((), dtype=torch.float32, device=pred.device)
    ptr = work.data_ptr()
    build.check("gs_loss", lib.gs_loss_forward(
        pred.data_ptr(), target.data_ptr(), addr, ptr, ptr + start * part_dtype.itemsize,
        loss.data_ptr(), build.stream_ptr()))
    gs_loss_fwd.launches += 2
    return loss, work


def gs_loss_bwd(pred: torch.Tensor, target: torch.Tensor, work: torch.Tensor,
                dloss: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """The backward kernel: dL/dpred (pred's shape, contiguous) from the
    forward's workspace and the loss's cotangent ``dloss`` (0-d, read on
    the device)."""
    lib, part_dtype = _library()
    _, addr, _, (_, total) = plan(pred, target, lambda_dssim)
    if work.dtype != part_dtype or work.shape != (total,):
        raise ValueError(f"gs_loss_bwd: expected the forward's workspace, ({total},) "
                         f"{part_dtype}, got {tuple(work.shape)} {work.dtype}")
    if dloss.dtype != torch.float32:
        dloss = dloss.to(torch.float32)
    out = torch.empty(pred.shape, dtype=torch.float32, device=pred.device)
    build.check("gs_loss_bwd", lib.gs_loss_backward(
        pred.data_ptr(), target.data_ptr(), addr, work.data_ptr(),
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
        loss, work = gs_loss_fwd(pred, target, lambda_dssim)
        ctx.save_for_backward(pred, target, work)
        ctx.lambda_dssim = lambda_dssim
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, dloss):
        pred, target, work = ctx.saved_tensors
        with span("gs.loss.bwd"):
            return gs_loss_bwd(pred, target, work, dloss, ctx.lambda_dssim), None, None
