"""Record expansion and the record sort.

Counterpart of ``openglgaussiansplattingrenderer_tpu/ops/pallas/records.py``
for the forward frame: the duplicate expansion (kernel ``csrc/expand.cu``)
and the stable payload sort, which is ``torch.sort(stable=True)`` on the key
plus one gather of the fields -- the JAX package's ``SORT_MODE="gather"``
form, proven bit-identical to its payload sort.

Records are kept as a (9, C) float32 field array (mx, my, A, B, C, op, r,
g, b), an int32 tile id per record (``num_tiles`` marks an invalid record)
and a float32 depth per record.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build

NUM_FIELDS = 9


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _ln_alpha_min(alpha_min: float) -> float:
    # the TPU kernel subtracts ln(alpha_min) rounded to float32
    return float(np.float32(np.log(alpha_min)))


def expand_plain(fields, tile_min, tile_ext, depth, cum_incl, *, capacity,
                 gx, num_tiles, pw, ph, alpha_min):
    """The plain PyTorch version of ``expand``: a searchsorted gather and
    the same cull arithmetic, in the same order."""
    dev = fields.device
    n = fields.shape[1]
    r = torch.arange(capacity, dtype=torch.int32, device=dev)
    if n == 0:
        return (torch.zeros((NUM_FIELDS, capacity), dtype=torch.float32, device=dev),
                torch.full((capacity,), num_tiles, dtype=torch.int32, device=dev),
                torch.zeros(capacity, dtype=torch.float32, device=dev))
    total = torch.clamp_max(cum_incl[-1], capacity)
    s = torch.searchsorted(cum_incl, r, right=True).clamp_max(n - 1)
    cum_excl = torch.cat([cum_incl.new_zeros(1), cum_incl[:-1]])
    j = r - cum_excl[s]
    ext = tile_ext[s, 0].clamp_min(1)
    q = torch.div(j, ext, rounding_mode="floor")
    ty = tile_min[s, 1] + q
    tx = tile_min[s, 0] + (j - q * ext)
    f = fields[:, s]

    mx, my, aa, bb, cc, op = f[0], f[1], f[2], f[3], f[4], f[5]
    x0 = tx.to(torch.float32) * float(pw)
    y0 = ty.to(torch.float32) * float(ph)
    dx0 = torch.clamp(mx, x0, x0 + (pw - 1)) - mx
    dy0 = torch.clamp(my, y0, y0 + (ph - 1)) - my
    ylo = y0 - my
    xlo = x0 - mx
    dys = torch.clamp(-bb * dx0 / torch.clamp_min(cc, 1e-12), ylo, ylo + (ph - 1))
    q1 = (aa * dx0 * dx0 + cc * dys * dys) + 2.0 * (bb * dx0 * dys)
    dxs = torch.clamp(-bb * dy0 / torch.clamp_min(aa, 1e-12), xlo, xlo + (pw - 1))
    q2 = (aa * dxs * dxs + cc * dy0 * dy0) + 2.0 * (bb * dxs * dy0)
    qmin = torch.minimum(q1, q2)
    ln_ratio = torch.log(torch.clamp_min(op, 1e-30)) - _ln_alpha_min(alpha_min)

    valid = r < total
    keep = valid & (qmin * 0.49999 <= ln_ratio + 1e-4)
    tile = torch.where(keep, ty * gx + tx, torch.full_like(ty, num_tiles))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return (torch.where(valid[None, :], f, zero), tile.to(torch.int32),
            torch.where(valid, depth[s], zero))


def expand(fields: torch.Tensor, tile_min: torch.Tensor, tile_ext: torch.Tensor,
           depth: torch.Tensor, cum_incl: torch.Tensor, *, capacity: int, gx: int,
           num_tiles: int, pw: int, ph: int, alpha_min: float
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Splat-major records from the per-splat table.

    Record r belongs to splat s with cum_excl[s] <= r < cum_incl[s]; it
    carries that splat's 9 ``fields`` (9, N), its tile (tile_min (N, 2),
    tile_ext (N, 2), row-major over the splat's tile rect) and its
    ``depth`` (N,). Records at or past total = min(cum_incl[-1], capacity)
    are zero with tile ``num_tiles``, and so is the tile of a record whose
    Gaussian cannot reach ``alpha_min`` anywhere in its pw x ph tile.
    Returns (fields (9, C) f32, tile (C,) int32, depth (C,) f32).
    """
    n = fields.shape[1]
    build.expect("expand fields", fields, torch.float32, (NUM_FIELDS, n))
    build.expect("expand tile_min", tile_min, torch.int32, (n, 2))
    build.expect("expand tile_ext", tile_ext, torch.int32, (n, 2))
    build.expect("expand depth", depth, torch.float32, (n,))
    build.expect("expand cum_incl", cum_incl, torch.int32, (n,))
    if capacity >= 2 ** 31:
        raise ValueError(f"expand: capacity {capacity} exceeds int32 indices")
    args = dict(capacity=capacity, gx=gx, num_tiles=num_tiles, pw=pw, ph=ph,
                alpha_min=alpha_min)
    if not build.on_cuda("expand", fields, tile_min, tile_ext, depth, cum_incl):
        return expand_plain(fields, tile_min, tile_ext, depth, cum_incl, **args)
    dev = fields.device
    out_f = torch.empty((NUM_FIELDS, capacity), dtype=torch.float32, device=dev)
    out_t = torch.empty(capacity, dtype=torch.int32, device=dev)
    out_d = torch.empty(capacity, dtype=torch.float32, device=dev)
    lib = build.load_library()
    build.check("expand", lib.gs_expand(
        fields.data_ptr(), tile_min.data_ptr(), tile_ext.data_ptr(),
        depth.data_ptr(), cum_incl.data_ptr(), n, out_f.data_ptr(),
        out_t.data_ptr(), out_d.data_ptr(), capacity, gx, num_tiles, pw, ph,
        _ln_alpha_min(alpha_min), build.stream_ptr()))
    expand.launches += 1
    return out_f, out_t, out_d


expand.launches = 0


def sort_with_payload(key: torch.Tensor, fields: torch.Tensor):
    """Stable sort by ``key``; returns (sorted_key, source_idx,
    sorted_fields) with ``fields`` (F, C) gathered along the record axis."""
    sk, si = torch.sort(key, stable=True)
    return sk, si, fields.index_select(1, si)


def pair_key(tile: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """One int64 key whose order is the lexicographic (tile, depth) order
    of the JAX package's ``sort_multi_with_payload((tile, depth), ...)``:
    tile in the high 32 bits, the float's bits mapped to an order-keeping
    unsigned integer in the low 32 (negative floats have their bits
    inverted, non-negative ones their sign bit set)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits + (1 << 31), -1 - bits)
    return (tile.to(torch.int64) << 32) + ordered


def packed_key(tile: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """tile * 2^22 + 22-bit quantised depth, the ``depth_key="packed"``
    key (held in int64; at most 512 tiles keep it below 2^32)."""
    qd = torch.clamp_max((depth.clamp(0.0, 1.0) * float(1 << 22)).to(torch.int64),
                         (1 << 22) - 1)
    return tile.to(torch.int64) * (1 << 22) + qd
