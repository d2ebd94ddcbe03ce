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
"""

from __future__ import annotations

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels.records import NUM_FIELDS


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


def composite_plain(rec, bounds, ox, oy, *, pw, ph, chunk, alpha_min,
                    alpha_max, thresh, pair_counts=None):
    """The plain PyTorch version, with the TPU kernel's formulation: chunks
    aligned to multiples of ``chunk`` in the sorted record array, vectorised
    over tiles and pixels; within a chunk the exclusive cumprod of 1 - alpha
    times the carried transmittance decides inclusion, and the carried
    transmittance becomes the masked minimum. Tiles whose range is done or
    whose pixels have all saturated drop out of later chunks.

    ``pair_counts``, a dict, receives the work the blend needs on these
    inputs: ``visited``, the (pixel, record) pairs met before the pixel
    saturated, and ``blended``, those of them whose alpha reached
    ``alpha_min`` (device scalars)."""
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
                        alpha_min, alpha_max, thresh):
    """The plain PyTorch version of the backward. It mirrors
    ``composite_plain`` step for step (the same aligned chunks, scanned
    transmittance prefix and masked-minimum carry), so with ``out`` from
    ``composite_plain`` it repeats that forward's keep and include
    decisions exactly. Returns the (9, C) record cotangents; columns no
    tile visits (past ``bounds[-1]``, or behind a saturated tile) are 0."""
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


def _check_launch_shape(lib, name, p, chunk):
    if p > lib.gs_composite_max_pixels() or not 0 < chunk <= 1024:
        raise ValueError(f"{name}: {p} pixels a tile (max "
                         f"{lib.gs_composite_max_pixels()}) or chunk {chunk} "
                         "(max 1024) out of range")


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
    p = pw * ph
    _check_launch_shape(lib, "composite", p, chunk)
    out = torch.empty((t, p, 4), dtype=torch.float32, device=rec.device)
    build.check("composite", lib.gs_composite_fwd(
        rec.data_ptr(), rec.shape[1], bounds.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), out.data_ptr(), t, pw, p, chunk, alpha_min, alpha_max,
        thresh, build.stream_ptr()))
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
    _check_launch_shape(lib, "composite_bwd", p, chunk)
    # zeroed: a block writes only the batches it visits before its tile
    # saturates, and no block writes past bounds[-1]
    drec = torch.zeros_like(rec)
    build.check("composite_bwd", lib.gs_composite_bwd(
        rec.data_ptr(), rec.shape[1], bounds.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), out.data_ptr(), g.data_ptr(), drec.data_ptr(), t, pw,
        p, chunk, alpha_min, alpha_max, thresh, build.stream_ptr()))
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
