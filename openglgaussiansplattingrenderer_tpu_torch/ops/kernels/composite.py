"""Tile compositor over (tile, depth)-sorted records, forward and backward.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/pallas/composite.py``;
the kernels are ``csrc/composite.cu`` (forward) and ``csrc/composite_bwd.cu``
(backward), joined by ``Composite``, a ``torch.autograd.Function``. For each
tile t the records in [bounds[t], bounds[t+1]) are blended front to back
into the tile's pixels:

    power = -(u^2 + v^2)     (the scaled Cholesky "sos" form of the conic)
    alpha = min(alpha_max, exp(power) * op), zeroed below alpha_min
    a record is included iff the transmittance before it is > thresh

The output is (T, p, 4): premultiplied rgb in colour-scale units and the
final transmittance, p = pw * ph pixels per tile, row-major.

The backward is analytic and keeps no per-record state from the forward:
its only residual is the forward's output. It walks the records front to
back again, recomputing alpha and the transmittance S_k before record k,
and carries D, the cotangent-weighted colour still to come (g_rgb . R_total
less the weighted colours up to k). With abar_k the included alpha, e_k =
g_rgb . colour_k and T_fin the final transmittance:

    dL/dabar_k = e_k S_k - (D_k + g_T T_fin) / (1 - abar_k)

which flows on only where the record was kept, included and not clamped at
alpha_max; dpower = dalpha * alpha, and the nine field gradients are sums
of dpower and the blend weight over the tile's pixels.

On the card a warp owns a patch of 32 pixels (``patch_shape``) and skips
the records that cannot reach ``alpha_min`` anywhere in it (in the box
around those of its pixels that are still alive); a block stages only the
records that pass the same test on the box around all of its live pixels.
The skip test is ``patch_reach_plain`` here, for any rect: conservative, so
the blend with it is the blend without it. ``composite_plain`` and
``composite_bwd_plain`` apply it per patch with ``patch_cull=True``, which
changes no bit of their results. ``chunk`` is the most records a staged
batch holds (the backward's holds at least one a thread); no result
depends on it.
"""

from __future__ import annotations

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels.records import (
    NUM_FIELDS,
    _ln_alpha_min,
)


def tile_origins(tile_ids: torch.Tensor, pw: int, ph: int, gx: int):
    """Per-tile pixel origins (ox, oy), int32, for a set of global tile ids."""
    tile_ids = tile_ids.to(torch.int32)
    return (tile_ids % gx) * pw, torch.div(tile_ids, gx, rounding_mode="floor") * ph


def _cumprod_excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumprod along the last axis as the TPU kernel computes it
    (multiplicative Hillis-Steele scan), so the plain version rounds the
    transmittance prefix in the same order."""
    n = x.shape[-1]
    ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    x = torch.cat([ones, x[..., :-1]], dim=-1)
    s = 1
    while s < n:
        x = x * torch.cat([ones.expand(x.shape[:-1] + (s,)), x[..., :-s]], dim=-1)
        s *= 2
    return x


def patch_shape(pw: int):
    """(px, py) of the pixel patch a warp owns on the card: px * py = 32, px
    the smallest power of two that covers the tile's width, at most 8."""
    px = 8
    while px > 1 and px // 2 >= pw:
        px //= 2
    return px, 32 // px


def patch_rects(pw: int, ph: int):
    """The tile-local pixel rects (x0, y0, x1, y1), inclusive and clipped to
    the tile, of the patches that cover a pw x ph tile, row-major, and the
    patch index of every pixel of the tile (p,) int64."""
    px, py = patch_shape(pw)
    pax, pay = -(-pw // px), -(-ph // py)
    rects = [(i * px, j * py, min((i + 1) * px, pw) - 1, min((j + 1) * py, ph) - 1)
             for j in range(pay) for i in range(pax)]
    pix = torch.arange(pw * ph)
    of_pixel = (torch.div(pix, pw, rounding_mode="floor") // py) * pax + (pix % pw) // px
    return rects, of_pixel


def _clip(x, lo, hi):
    # fminf(fmaxf(x, lo), hi): as the kernel clips
    return torch.minimum(torch.maximum(x, lo), hi)


def patch_reach_plain(rec, ox, oy, rect, alpha_min):
    """The plain PyTorch version of the kernels' skip test: can record
    ``rec`` (9, ...) of a tile with pixel origin ``ox``, ``oy`` (broadcast
    against ``rec[0]``) reach ``alpha_min`` anywhere in the tile-local
    pixel rect ``rect`` = (x0, y0, x1, y1), inclusive (numbers or tensors
    that broadcast)? The exact minimum of the conic quadratic over the rect
    (the smaller of the two KKT edge candidates, with the expansion cull's
    margins) against ln(op / alpha_min). Conservative: a record it drops
    has alpha < alpha_min at every pixel of the rect; records with a
    non-finite field or a conic whose Cholesky factors the blend clamps
    always pass. Returns a bool tensor."""
    f32 = dict(dtype=torch.float32, device=rec.device)
    x0, y0, x1, y1 = (torch.as_tensor(v, **f32) for v in rect)
    mxl = rec[0] - torch.as_tensor(ox, device=rec.device).to(torch.float32)
    myl = rec[1] - torch.as_tensor(oy, device=rec.device).to(torch.float32)
    aa, bb, cc, op = rec[2], rec[3], rec[4], rec[5]
    s11 = torch.sqrt(torch.clamp_min(aa * 0.5, 0.0))
    s12 = (bb * 0.5) / torch.clamp_min(s11, 1e-20)
    finite = (torch.isfinite(mxl) & torch.isfinite(myl) & torch.isfinite(aa)
              & torch.isfinite(bb) & torch.isfinite(cc) & torch.isfinite(op))
    proper = (s11 >= 1e-20) & (cc * 0.5 - s12 * s12 >= 0.0)
    lnr = torch.log(torch.clamp_min(op, 1e-30)) - _ln_alpha_min(alpha_min)
    limit = torch.where(finite & proper, lnr, torch.full_like(lnr, float("inf"))) + 1e-4
    dx0 = _clip(mxl, x0, x1) - mxl
    dy0 = _clip(myl, y0, y1) - myl
    dys = _clip(-bb * dx0 / torch.clamp_min(cc, 1e-12), y0 - myl, y1 - myl)
    q1 = (aa * dx0 * dx0 + cc * dys * dys) + 2.0 * (bb * dx0 * dys)
    dxs = _clip(-bb * dy0 / torch.clamp_min(aa, 1e-12), x0 - mxl, x1 - mxl)
    q2 = (aa * dxs * dxs + cc * dy0 * dy0) + 2.0 * (bb * dxs * dy0)
    return ~((q1 * 0.49999 > limit) & (q2 * 0.49999 > limit))


def _patch_mask(r, oxa, oya, pw, ph, alpha_min):
    """(A, p, chunk) bool: does record (a, k) of ``r`` (9, A, chunk) reach the
    patch that pixel p lies in, for tiles with origins ``oxa``, ``oya`` (A,)."""
    rects, of_pixel = patch_rects(pw, ph)
    rect = [torch.tensor([q[i] for q in rects], dtype=torch.float32,
                         device=r.device)[None, :, None] for i in range(4)]
    reach = patch_reach_plain(r[:, :, None, :], oxa[:, None, None], oya[:, None, None],
                              rect, alpha_min)                    # (A, patches, chunk)
    return reach[:, of_pixel.to(r.device), :]


def composite_plain(rec, bounds, ox, oy, *, pw, ph, chunk, alpha_min,
                    alpha_max, thresh, pair_counts=None, patch_cull=False):
    """The plain PyTorch version, with the TPU kernel's formulation: chunks
    aligned to multiples of ``chunk`` in the sorted record array, vectorised
    over tiles and pixels; within a chunk the exclusive cumprod of 1 - alpha
    times the carried transmittance decides inclusion, and the carried
    transmittance becomes the masked minimum. Tiles whose range is done or
    whose pixels have all saturated drop out of later chunks.

    ``pair_counts``, a dict, receives the work the blend needs on these
    inputs: ``visited``, the (pixel, record) pairs met before the pixel
    saturated, and ``blended``, those of them whose alpha reached
    ``alpha_min`` (device scalars). ``patch_cull`` zeroes a record's alpha
    in the pixel patches ``patch_reach_plain`` says it cannot reach, as the
    kernel skips it there; the result is the same to the bit."""
    dev = rec.device
    t = bounds.shape[0] - 1
    p = pw * ph
    c_total = rec.shape[1]
    pix = torch.arange(p, device=dev)
    fx = (pix % pw).to(torch.float32)[None, :, None]
    fy = torch.div(pix, pw, rounding_mode="floor").to(torch.float32)[None, :, None]
    b0 = bounds[:-1].to(torch.int64)
    b1 = bounds[1:].to(torch.int64)
    start = torch.div(b0, chunk, rounding_mode="floor") * chunk
    nch = torch.div(b1 - start + chunk - 1, chunk, rounding_mode="floor")
    lane = torch.arange(chunk, device=dev)
    rgb = torch.zeros((t, p, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((t, p), dtype=torch.float32, device=dev)
    for c in range(int(nch.max()) if t else 0):
        act = torch.nonzero((c < nch) & (trans.amax(dim=1) > thresh)).squeeze(1)
        if act.numel() == 0:
            break
        k = start[act, None] + c * chunk + lane[None, :]          # (A, chunk)
        in_range = (k >= b0[act, None]) & (k < b1[act, None])
        r = rec[:, k.clamp_max(c_total - 1)]                      # (9, A, chunk)
        mxl = r[0] - ox[act, None].to(torch.float32)
        myl = r[1] - oy[act, None].to(torch.float32)
        s11 = torch.sqrt(torch.clamp_min(r[2] * 0.5, 0.0))
        s12 = (r[3] * 0.5) / torch.clamp_min(s11, 1e-20)
        s22 = torch.sqrt(torch.clamp_min(r[4] * 0.5 - s12 * s12, 0.0))
        u0 = -(s11 * mxl + s12 * myl)
        v0 = -(s22 * myl)
        opm = torch.where(in_range, r[5], torch.zeros((), device=dev))
        s11, s12, s22, u0, v0, opm = (a[:, None, :] for a in (s11, s12, s22, u0, v0, opm))
        u = s11 * fx + (s12 * fy + u0)                            # (A, p, chunk)
        v = s22 * fy + v0
        power = -(u * u + v * v)
        alpha = torch.clamp_max(torch.exp(power) * opm, alpha_max)
        alpha = torch.where(alpha >= alpha_min, alpha, torch.zeros((), device=dev))
        if patch_cull:
            alpha = torch.where(_patch_mask(r, ox[act], oy[act], pw, ph, alpha_min),
                                alpha, torch.zeros((), device=dev))
        one_m = 1.0 - alpha
        tr = trans[act][:, :, None]
        s_excl = tr * _cumprod_excl(one_m)
        inc = s_excl > thresh
        w = torch.where(inc, alpha * s_excl, torch.zeros((), device=dev))
        rgb[act] += torch.einsum("apk,cak->apc", w, r[6:9])
        trans[act] = torch.where(inc, s_excl * one_m, tr).amin(dim=2)
        if pair_counts is not None:
            met = inc & in_range[:, None, :]
            for name, mask in (("visited", met), ("blended", met & (alpha > 0))):
                pair_counts[name] = pair_counts.get(name, 0) + mask.sum()
    return torch.cat([rgb, trans[:, :, None]], dim=2)


def composite_bwd_plain(rec, bounds, ox, oy, out, g, *, pw, ph, chunk,
                        alpha_min, alpha_max, thresh, patch_cull=False):
    """The plain PyTorch version of the backward. It mirrors
    ``composite_plain`` step for step (the same aligned chunks, scanned
    transmittance prefix and masked-minimum carry), so with ``out`` from
    ``composite_plain`` it repeats that forward's keep and include
    decisions exactly. Returns the (9, C) record cotangents; columns no
    tile visits (past ``bounds[-1]``, or behind a saturated tile) are 0.
    ``patch_cull`` as in ``composite_plain``."""
    dev = rec.device
    t = bounds.shape[0] - 1
    p = pw * ph
    c_total = rec.shape[1]
    drec = torch.zeros_like(rec)
    pix = torch.arange(p, device=dev)
    fx = (pix % pw).to(torch.float32)[None, :, None]
    fy = torch.div(pix, pw, rounding_mode="floor").to(torch.float32)[None, :, None]
    b0 = bounds[:-1].to(torch.int64)
    b1 = bounds[1:].to(torch.int64)
    start = torch.div(b0, chunk, rounding_mode="floor") * chunk
    nch = torch.div(b1 - start + chunk - 1, chunk, rounding_mode="floor")
    lane = torch.arange(chunk, device=dev)
    zero = torch.zeros((), device=dev)
    trans = torch.ones((t, p), dtype=torch.float32, device=dev)
    d_carry = (g[:, :, 0:3] * out[:, :, 0:3]).sum(dim=2)           # (T, p)
    gt_tfin = g[:, :, 3] * out[:, :, 3]
    for c in range(int(nch.max()) if t else 0):
        act = torch.nonzero((c < nch) & (trans.amax(dim=1) > thresh)).squeeze(1)
        if act.numel() == 0:
            break
        k = start[act, None] + c * chunk + lane[None, :]          # (A, chunk)
        in_range = (k >= b0[act, None]) & (k < b1[act, None])
        r = rec[:, k.clamp_max(c_total - 1)]                      # (9, A, chunk)
        mxl = r[0] - ox[act, None].to(torch.float32)
        myl = r[1] - oy[act, None].to(torch.float32)
        s11 = torch.sqrt(torch.clamp_min(r[2] * 0.5, 0.0))
        s12 = (r[3] * 0.5) / torch.clamp_min(s11, 1e-20)
        s22 = torch.sqrt(torch.clamp_min(r[4] * 0.5 - s12 * s12, 0.0))
        u0 = -(s11 * mxl + s12 * myl)
        v0 = -(s22 * myl)
        opm = torch.where(in_range, r[5], zero)
        s11, s12, s22, u0, v0, opm = (a[:, None, :] for a in (s11, s12, s22, u0, v0, opm))
        u = s11 * fx + (s12 * fy + u0)                            # (A, p, chunk)
        v = s22 * fy + v0
        power = -(u * u + v * v)
        alpha_pre = torch.exp(power) * opm
        alpha = torch.clamp_max(alpha_pre, alpha_max)
        keep = alpha >= alpha_min
        if patch_cull:
            keep = keep & _patch_mask(r, ox[act], oy[act], pw, ph, alpha_min)
        alpha = torch.where(keep, alpha, zero)
        one_m = 1.0 - alpha
        tr = trans[act][:, :, None]
        s_excl = tr * _cumprod_excl(one_m)
        inc = s_excl > thresh
        abar = torch.where(inc, alpha, zero)
        w = abar * s_excl

        ga = g[act]                                               # (A, p, 4)
        e = torch.einsum("apc,cak->apk", ga[:, :, 0:3], r[6:9])
        vsum = torch.cumsum(w * e, dim=2)
        rest = d_carry[act][:, :, None] - vsum + gt_tfin[act][:, :, None]
        dabar = e * s_excl - rest / (1.0 - abar)
        gate = keep & inc & (alpha_pre < alpha_max)
        dpower = torch.where(gate, dabar, zero) * alpha
        dx = fx - mxl[:, None, :]
        dy = fy - myl[:, None, :]
        s1 = dpower.sum(dim=1)                                    # (A, chunk)
        sx = (dpower * dx).sum(dim=1)
        sy = (dpower * dy).sum(dim=1)
        grads = torch.stack([
            r[2] * sx + r[3] * sy,
            r[4] * sy + r[3] * sx,
            -0.5 * (dpower * dx * dx).sum(dim=1),
            -(dpower * dx * dy).sum(dim=1),
            -0.5 * (dpower * dy * dy).sum(dim=1),
            s1 / torch.clamp_min(r[5], 1e-12),
            *torch.einsum("apk,apc->cak", w, ga[:, :, 0:3])])     # (9, A, chunk)
        drec[:, k[in_range]] = grads[:, in_range]

        trans[act] = torch.where(inc, s_excl * one_m, tr).amin(dim=2)
        d_carry[act] = d_carry[act] - vsum[:, :, -1]
    return drec


def _expect_inputs(name, rec, bounds, ox, oy):
    t = bounds.shape[0] - 1
    build.expect(f"{name} rec", rec, torch.float32, (NUM_FIELDS, None))
    build.expect(f"{name} bounds", bounds, torch.int32, (t + 1,))
    build.expect(f"{name} ox", ox, torch.int32, (t,))
    build.expect(f"{name} oy", oy, torch.int32, (t,))
    return t


def _check_launch_shape(lib, name, pw, ph, chunk):
    px, py = patch_shape(pw)
    patches = -(-pw // px) * -(-ph // (4 * py))     # a lane takes up to 4 patches
    if (min(pw, ph) <= 0 or pw * ph > lib.gs_composite_max_pixels()
            or patches > 16 or not 0 < chunk <= 1024):
        raise ValueError(f"{name}: a {pw}x{ph} tile (max "
                         f"{lib.gs_composite_max_pixels()} pixels, {px}x{4 * py} "
                         f"patches for 16 warps) or chunk {chunk} (max 1024) "
                         "out of range")


def composite_fwd(rec, bounds, ox, oy, *, pw, ph, chunk, alpha_min, alpha_max,
                  thresh):
    """The forward alone (no autograd graph): the CUDA kernel for CUDA
    tensors, ``composite_plain`` for CPU tensors."""
    t = _expect_inputs("composite", rec, bounds, ox, oy)
    args = dict(pw=pw, ph=ph, chunk=chunk, alpha_min=alpha_min,
                alpha_max=alpha_max, thresh=thresh)
    if not build.on_cuda("composite", rec, bounds, ox, oy):
        return composite_plain(rec, bounds, ox, oy, **args)
    lib = build.load_library()
    _check_launch_shape(lib, "composite", pw, ph, chunk)
    out = torch.empty((t, pw * ph, 4), dtype=torch.float32, device=rec.device)
    if t == 0:
        return out
    build.check("composite", lib.gs_composite_fwd(
        rec.data_ptr(), rec.shape[1], bounds.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), out.data_ptr(), t, pw, ph, chunk, alpha_min, alpha_max,
        thresh, _ln_alpha_min(alpha_min), build.stream_ptr()))
    composite.launches += 1
    return out


def composite_bwd(rec, bounds, ox, oy, out, g, *, pw, ph, chunk, alpha_min,
                  alpha_max, thresh):
    """Record cotangents (9, C) from the output cotangent ``g`` (T, p, 4)
    and the forward's own output ``out``: the CUDA kernel for CUDA tensors,
    ``composite_bwd_plain`` for CPU tensors."""
    t = _expect_inputs("composite_bwd", rec, bounds, ox, oy)
    p = pw * ph
    build.expect("composite_bwd out", out, torch.float32, (t, p, 4))
    build.expect("composite_bwd g", g, torch.float32, (t, p, 4))
    args = dict(pw=pw, ph=ph, chunk=chunk, alpha_min=alpha_min,
                alpha_max=alpha_max, thresh=thresh)
    if not build.on_cuda("composite_bwd", rec, bounds, ox, oy, out, g):
        return composite_bwd_plain(rec, bounds, ox, oy, out, g, **args)
    lib = build.load_library()
    _check_launch_shape(lib, "composite_bwd", pw, ph, chunk)
    if t == 0:
        return torch.zeros_like(rec)
    # not cleared: the kernel writes every column, zeros where no tile's
    # walk arrives (behind saturation, outside [bounds[0], bounds[-1]))
    drec = torch.empty_like(rec)
    build.check("composite_bwd", lib.gs_composite_bwd(
        rec.data_ptr(), rec.shape[1], bounds.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), out.data_ptr(), g.data_ptr(), drec.data_ptr(), t, pw,
        ph, chunk, alpha_min, alpha_max, thresh, _ln_alpha_min(alpha_min),
        build.stream_ptr()))
    composite_bwd.launches += 1
    return drec


class Composite(torch.autograd.Function):
    """``composite_fwd`` with ``composite_bwd`` as its gradient with respect
    to the records; bounds and origins are integers and get none."""

    @staticmethod
    def forward(ctx, rec, bounds, ox, oy, pw, ph, chunk, alpha_min, alpha_max,
                thresh):
        ctx.args = dict(pw=pw, ph=ph, chunk=chunk, alpha_min=alpha_min,
                        alpha_max=alpha_max, thresh=thresh)
        out = composite_fwd(rec, bounds, ox, oy, **ctx.args)
        ctx.save_for_backward(rec, bounds, ox, oy, out)
        return out

    @staticmethod
    def backward(ctx, g):
        rec, bounds, ox, oy, out = ctx.saved_tensors
        drec = composite_bwd(rec, bounds, ox, oy, out, g.contiguous(), **ctx.args)
        return (drec,) + (None,) * 9


def composite(rec: torch.Tensor, bounds: torch.Tensor, ox: torch.Tensor,
              oy: torch.Tensor, *, pw: int, ph: int, chunk: int,
              alpha_min: float, alpha_max: float, thresh: float) -> torch.Tensor:
    """Composite sorted records ``rec`` (9, C) over the tiles of ``bounds``
    (T+1,) int32 (values <= C), with per-tile pixel origins ``ox``, ``oy``
    (T,) int32. Returns (T, pw*ph, 4) float32, differentiable with respect
    to ``rec``. ``composite.launches`` counts forward kernel launches,
    ``composite_bwd.launches`` backward ones."""
    return Composite.apply(rec, bounds, ox, oy, pw, ph, chunk, alpha_min,
                           alpha_max, thresh)


composite.launches = 0
composite_bwd.launches = 0
