"""Tile compositor forward over (tile, depth)-sorted records.

Counterpart of the forward of
``openglgaussiansplattingrenderer_tpu/ops/pallas/composite.py``; the kernel
is ``csrc/composite.cu``. For each tile t the records in
[bounds[t], bounds[t+1]) are blended front to back into the tile's pixels:

    power = -(u^2 + v^2)     (the scaled Cholesky "sos" form of the conic)
    alpha = min(alpha_max, exp(power) * op), zeroed below alpha_min
    a record is included iff the transmittance before it is > thresh

The output is (T, p, 4): premultiplied rgb in colour-scale units and the
final transmittance, p = pw * ph pixels per tile, row-major.
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
                    alpha_max, thresh):
    """The plain PyTorch version, with the TPU kernel's formulation: chunks
    aligned to multiples of ``chunk`` in the sorted record array, vectorised
    over tiles and pixels; within a chunk the exclusive cumprod of 1 - alpha
    times the carried transmittance decides inclusion, and the carried
    transmittance becomes the masked minimum. Tiles whose range is done or
    whose pixels have all saturated drop out of later chunks."""
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
    return torch.cat([rgb, trans[:, :, None]], dim=2)


def composite(rec: torch.Tensor, bounds: torch.Tensor, ox: torch.Tensor,
              oy: torch.Tensor, *, pw: int, ph: int, chunk: int,
              alpha_min: float, alpha_max: float, thresh: float) -> torch.Tensor:
    """Composite sorted records ``rec`` (9, C) over the tiles of ``bounds``
    (T+1,) int32 (values <= C), with per-tile pixel origins ``ox``, ``oy``
    (T,) int32. Returns (T, pw*ph, 4) float32."""
    t = bounds.shape[0] - 1
    build.expect("composite rec", rec, torch.float32, (NUM_FIELDS, None))
    build.expect("composite bounds", bounds, torch.int32, (t + 1,))
    build.expect("composite ox", ox, torch.int32, (t,))
    build.expect("composite oy", oy, torch.int32, (t,))
    args = dict(pw=pw, ph=ph, chunk=chunk, alpha_min=alpha_min,
                alpha_max=alpha_max, thresh=thresh)
    if not build.on_cuda("composite", rec, bounds, ox, oy):
        return composite_plain(rec, bounds, ox, oy, **args)
    lib = build.load_library()
    p = pw * ph
    if p > lib.gs_composite_max_pixels() or not 0 < chunk <= 1024:
        raise ValueError(f"composite: {p} pixels a tile (max "
                         f"{lib.gs_composite_max_pixels()}) or chunk {chunk} "
                         "(max 1024) out of range")
    out = torch.empty((t, p, 4), dtype=torch.float32, device=rec.device)
    build.check("composite", lib.gs_composite_fwd(
        rec.data_ptr(), rec.shape[1], bounds.data_ptr(), ox.data_ptr(),
        oy.data_ptr(), out.data_ptr(), t, pw, p, chunk, alpha_min, alpha_max,
        thresh, build.stream_ptr()))
    composite.launches += 1
    return out


composite.launches = 0
