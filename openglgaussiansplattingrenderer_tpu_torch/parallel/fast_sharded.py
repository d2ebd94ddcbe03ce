"""Multi-device fast path: the kernels on every shard, with a record
exchange by tile owner.

Counterpart of ``openglgaussiansplattingrenderer_tpu/parallel/fast_sharded.py``,
on the port's single-controller mesh (``parallel/sharded.py``):

- **splat-sharded preprocess + expand**: each shard runs the fast path's
  table, prefix sum (kernel 1) and expansion (kernel 2) on its N/D splats,
  producing splat-major records that carry (9 fields, tile id, depth).
- **bucketing by tile owner**: tiles are owned round-robin (``owner(t) = t
  % D``, which spreads dense screen regions over the shards). A record's
  rank among the local records bound for owner e comes from D mask prefix
  sums (kernel 1 again); each shard lays its records into D fixed-capacity
  buckets with ONE stable sort of the records' bucket rows against
  padding rows. Bucket capacity is static (``exch_factor`` x the mean);
  the records past it (the last in the shard's record order: the farthest
  under ``hoist_depth_sort``) are dropped and counted in
  ``stats["overflow"]``.
- **the exchange**: one ``all_to_all`` of the (D x cap_exch, 11) buckets.
- **owner-side merge + composite**: the owner merges the D streams with one
  stable (local tile, depth) sort (``records.pair_key``) and composites its
  non-contiguous tile subset ``d + D * arange(T / D)`` with kernel 4,
  through per-tile pixel origins.
- **backward**: autograd transposes every step: the compositor's backward
  is kernel 5, the sorts put cotangents back by their permutations, the
  all-to-all reverses, and the expansion's backward is the segment sum
  (kernel 3). A splat duplicated across tiles of different owners receives
  the exact sum of its contributions.
- **q16 inference mode** (``cfg.sort_payload == "q16"``): the 9 fields ride
  the bucket sort, the exchange and the merge packed into 5 u32 words (the
  single-device q16 pack) and the merge sorts one 22-bit depth key, all in
  one ``torch.autograd.Function`` whose backward raises.

With the records of contiguous splat shards merged stably in shard order,
a tile's records reach the compositor in the single-device frame's order,
so a frame with no drops is the single-device frame.

The frame is four stages, each a function of this module:
``shard_records`` (one shard's table, expansion and bucket layout), the
exchange (``mesh.all_to_all``), ``merge_records`` + ``owner_tiles`` (one
owner's merge and composite, its ``(T / D, P, 4)`` tiles) and
``assemble`` (the image).
``render_tiles`` runs the first three over the mesh's local shards and
``render_fast_sharded`` adds the fourth; ``parallel/mesh2d.py`` scores the
owned tiles without assembling. Every collective is a method of the mesh,
so the single-controller mesh (every shard) and ``parallel.multihost``'s
process mesh (its rank's shard) run the same stage code.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import (
    assemble_image,
    padded_dims,
)
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import records as kr
from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import scan as ks
from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import (
    Mesh,
    check_tiles,
    make_mesh,
    matrix_on,
    on_device,
    pad_scene_for_mesh,
    shard_params,
    step_sharded,
)

__all__ = ["render_fast_sharded", "render_tiles", "train_step_fast_sharded",
           "make_mesh", "pad_scene_for_mesh", "shard_params", "exchange_capacity",
           "warn_on_sharded_overflow"]

NUM_COLS = kr.NUM_FIELDS + 2       # the 9 fields, tile, depth


def exchange_capacity(cfg: RenderConfig, n_local: int, ndev: int,
                      exch_factor: float = 2.0) -> int:
    """Static per-destination bucket capacity of the record exchange.

    ``exch_factor`` multiplies the mean per-destination share of a shard's
    local record capacity; ``exch_factor >= ndev`` guarantees zero drops
    (worst case: every local record bound for one owner)."""
    cap_local = kr.round_up(cfg.capacity(n_local), fastpath.CAPACITY_MULTIPLE)
    return kr.round_up(max(int(cap_local * exch_factor / ndev), 128), 128)


def _bucket_rows(tile: torch.Tensor, ndev: int, cap_exch: int, num_tiles: int):
    """The bucket layout of one shard's records, as sort keys.

    Returns (row key of each record (C,), row key of each of the D *
    cap_exch padding rows, records bound for each owner (D,)): every key
    in [0, D * cap_exch) occurs once across records and padding, record j
    bound for owner e at rank r < cap_exch takes row e * cap_exch + r, the
    padding fills each bucket's rows past its count, and every other
    record or padding row takes a distinct key past them. Invalid records
    (tile == num_tiles) go to no owner."""
    dev = tile.device
    cap_local = tile.shape[0]
    dest = torch.where(tile < num_tiles, tile % ndev, torch.full_like(tile, ndev))
    rank = torch.zeros_like(tile)
    counts = []
    for e in range(ndev):
        m = (dest == e).to(torch.int32)
        c = ks.cumsum(m)
        rank = torch.where(m == 1, c - 1, rank)
        counts.append(c[-1])
    counts = torch.stack(counts)
    rows = ndev * cap_exch
    in_cap = (dest < ndev) & (rank < cap_exch)
    rkey = torch.where(in_cap, dest.long() * cap_exch + rank,
                       rows + torch.arange(cap_local, device=dev))
    p = torch.arange(rows, device=dev)
    fill = counts.clamp_max(cap_exch).long().repeat_interleave(cap_exch) + p % cap_exch
    pkey = torch.where(fill < cap_exch, (p // cap_exch) * cap_exch + fill,
                       rows + cap_local + p)
    return rkey, pkey, counts


def _pack(cols: torch.Tensor, pad: torch.Tensor, rkey, pkey, rows: int):
    """(rows, F) buckets: the columns ``cols`` (F, C) of the records laid out
    by one stable sort of their row keys against the padding rows' keys;
    a padding row is ``pad`` (F,). Differentiable in ``cols`` (the gather's
    transpose puts each bucket row's cotangent back on its record)."""
    c = cols.shape[1]
    src = torch.sort(torch.cat([rkey, pkey]), stable=True)[1][:rows]
    src = torch.where(src < c, src, torch.full_like(src, c))   # padding -> pad
    return torch.cat([cols, pad[:, None]], dim=1).t().index_select(0, src)


def _merge_bounds(sorted_key: torch.Tensor, tpd: int, shift: int) -> torch.Tensor:
    edges = torch.arange(tpd + 1, dtype=torch.int64, device=sorted_key.device) << shift
    return torch.searchsorted(sorted_key, edges, right=False).to(torch.int32)


def _local_tile(gtile: torch.Tensor, ndev: int, num_tiles: int, tpd: int):
    """Owned global tile g = lt * D + d -> local index lt; padding -> tpd."""
    return torch.where(gtile < num_tiles, gtile // ndev, torch.full_like(gtile, tpd))


class Q16Route(torch.autograd.Function):
    """The q16 region of every shard, bucket sort -> all-to-all -> owner
    merge, as one function: f32 fields in, f32 sorted fields and bounds
    out. The 9 fields travel as the 5 u32 words of ``records.q16_pack``
    (their bits viewed as f32, so every exchange column shares one dtype);
    the merge sorts one key, local tile * 2^22 + 22-bit depth
    (``records.packed_key``). Inference only: the backward raises (round
    and clamp are flat almost everywhere; a silent zero gradient would be
    a trap)."""

    @staticmethod
    def forward(ctx, mesh, rows, num_tiles, tpd, wp, hp, *flat):
        ndev = mesh.size
        packed = []
        for i, (_, dev) in enumerate(mesh.local):
            fields9, tile, depth, rkey, pkey = flat[5 * i:5 * i + 5]
            with on_device(dev):
                words = kr.q16_pack(fields9, wp, hp).view(torch.float32)
                cols = torch.cat([words, tile.to(torch.float32)[None], depth[None]])
                pad = torch.zeros(7, device=dev)
                pad[5] = num_tiles
                packed.append(_pack(cols, pad, rkey, pkey, rows))
        out = []
        for (_, dev), recv in zip(mesh.local, mesh.all_to_all(packed)):
            with on_device(dev):
                lt = _local_tile(recv[:, 5].to(torch.int32), ndev, num_tiles, tpd)
                sk, si = torch.sort(kr.packed_key(lt, recv[:, 6]), stable=True)
                words = recv[:, :5].t().contiguous().view(torch.int32)
                out += [kr.q16_unpack(words.index_select(1, si), wp, hp),
                        _merge_bounds(sk, tpd, kr.PACKED_DEPTH_BITS)]
        ctx.mark_non_differentiable(*out[1::2])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "sort_payload='q16' is an inference-only precision mode: the "
            "quantized sharded record exchange has no useful gradient. Train "
            "with sort_payload='f32'.")


def shard_records(p, dev, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                  width: int, height: int, cfg: RenderConfig, ndev: int,
                  cap_exch: int):
    """Stage 1, one shard on ``dev``: the fast path's table, prefix sum
    (kernel 1) and expansion (kernel 2) of its splats ``p``, then the
    bucket layout by tile owner. Returns (buckets, info, records bound for
    each owner (D,)): the buckets are the (D * cap_exch, 11) exchange rows,
    or under q16 the tuple ``Q16Route`` packs."""
    t = cfg.num_tiles
    with on_device(dev):
        rec_f, rec_t, rec_d, info = fastpath.expand_depth_records(
            p, matrix_on(view, dev), matrix_on(vp, dev), focal_x, focal_y,
            tan_fovx, tan_fovy, width, height, cfg)
        rkey, pkey, cnt = _bucket_rows(rec_t, ndev, cap_exch, t)
        if cfg.sort_payload == "q16":
            return (rec_f, rec_t, rec_d, rkey, pkey), info, cnt
        cols = torch.cat([rec_f, rec_t.to(torch.float32)[None], rec_d[None]])
        pad = torch.zeros(NUM_COLS, device=dev)
        pad[kr.NUM_FIELDS] = t            # the padding sorts after every tile
        return _pack(cols, pad, rkey, pkey, ndev * cap_exch), info, cnt


def merge_records(recv: torch.Tensor, dev, ndev: int, num_tiles: int, tpd: int):
    """The owner's merge of its received rows: one stable (local tile,
    depth) sort (``records.pair_key``). Returns (sorted fields (9, R),
    bounds (tpd + 1,))."""
    with on_device(dev):
        lt = _local_tile(recv[:, kr.NUM_FIELDS].to(torch.int32), ndev, num_tiles, tpd)
        sk, _, sf = kr.sort_with_payload(kr.pair_key(lt, recv[:, kr.NUM_FIELDS + 1]),
                                         recv[:, :kr.NUM_FIELDS].t())
        return sf, _merge_bounds(sk, tpd, 32)


def owned_tiles(d: int, ndev: int, tpd: int, device) -> torch.Tensor:
    """Global ids of the tiles owner d composites: ``d + D * arange(T / D)``."""
    return d + ndev * torch.arange(tpd, dtype=torch.int32, device=device)


def owner_tiles(sf, bounds, d: int, dev, ndev: int, tpd: int, width: int,
                height: int, cfg: RenderConfig) -> torch.Tensor:
    """Stage 3, owner d: kernel 4 over its round-robin tiles. Returns the
    (tpd, P, 4) premultiplied rgb and final transmittance of tiles
    ``owned_tiles(d, ...)``, in that order."""
    with on_device(dev):
        return fastpath.composite_sorted(
            sf, bounds, num_tiles=tpd, tile_ids=owned_tiles(d, ndev, tpd, dev),
            width=width, height=height, cfg=cfg)[0]


def render_tiles(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
                 width: int, height: int, cfg: RenderConfig, mesh: Mesh,
                 exch_factor: float = 2.0):
    """Stages 1-3 over the mesh's local shards. Returns (one (T / D, P, 4)
    tensor of owned tiles per local shard, on its device, stats on
    ``mesh.out_device``): see ``render_fast_sharded``."""
    shards = mesh.local_shards(params)
    ndev, t = mesh.size, cfg.num_tiles
    tpd = check_tiles(cfg, mesh)
    cap_exch = exchange_capacity(cfg, shards[0]["means"].shape[0], ndev, exch_factor)
    rows = ndev * cap_exch

    local, infos, counts = [], [], []
    for (_, dev), p in zip(mesh.local, shards):
        buckets, info, cnt = shard_records(p, dev, view, vp, focal_x, focal_y,
                                           tan_fovx, tan_fovy, width, height, cfg,
                                           ndev, cap_exch)
        local.append(buckets)
        infos.append(info)
        counts.append(cnt)

    if cfg.sort_payload == "q16":
        wp, hp = padded_dims(width, height, cfg)
        flat = [x for shard in local for x in shard]
        merged = Q16Route.apply(mesh, rows, t, tpd, wp, hp, *flat)
        merged = list(zip(merged[0::2], merged[1::2]))
    else:
        # stage 2, the exchange: owner d receives bucket d of every shard
        merged = [merge_records(recv, dev, ndev, t, tpd)
                  for (_, dev), recv in zip(mesh.local, mesh.all_to_all(local))]

    tiled = [owner_tiles(sf, bounds, d, dev, ndev, tpd, width, height, cfg)
             for (d, dev), (sf, bounds) in zip(mesh.local, merged)]

    def total(xs):
        on = [x.to(dev) for x, (_, dev) in zip(xs, mesh.local)]
        return mesh.psum(on)[0].to(mesh.out_device)

    local_over = total([(i["total_all"] - i["total"]).clamp_min(0) for i in infos])
    bucket_over = total([(c - cap_exch).clamp_min(0).sum() for c in counts])
    stats = {"overflow": local_over + bucket_over,
             "num_records": total([i["total"] for i in infos]),
             "exchanged_records": total([c.sum() for c in counts])}
    return tiled, stats


def assemble(tiled, mesh: Mesh, width: int, height: int, cfg: RenderConfig):
    """Stage 4: every owner's tiles, gathered in owner order on
    ``mesh.out_device``, put back in global tile order and assembled into
    the (H, W, 4) image."""
    ndev, t = mesh.size, cfg.num_tiles
    tpd = t // ndev
    stacked = mesh.gather(tiled)
    # stacked order is (owner d, local lt) -> global tile lt * D + d
    g = torch.arange(t, device=stacked.device)
    tiled = stacked[(g % ndev) * tpd + g // ndev]
    return assemble_image(tiled[:, :, 0:3], tiled[:, :, 3], width, height, cfg)


def render_fast_sharded(params, view, vp, focal_x, focal_y, tan_fovx,
                        tan_fovy, width: int, height: int, cfg: RenderConfig,
                        mesh: Mesh, exch_factor: float = 2.0
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Multi-device fast render. Returns ((H, W, 4) image, stats), both on
    ``mesh.out_device`` (``devices[0]`` of a single-controller mesh).

    ``params`` is a global dict (its row count divisible by the mesh size:
    ``pad_scene_for_mesh``) or one dict per local shard (``shard_params``).
    ``exch_factor`` sizes the exchange buckets (``exchange_capacity``);
    ``exch_factor=D`` guarantees zero drops at D times the exchange
    memory. Stats (device tensors): ``overflow`` (records dropped by the
    local capacity or the buckets), ``num_records``, ``exchanged_records``.
    """
    tiled, stats = render_tiles(params, view, vp, focal_x, focal_y, tan_fovx,
                                tan_fovy, width, height, cfg, mesh, exch_factor)
    return assemble(tiled, mesh, width, height, cfg), stats


def train_step_fast_sharded(raw, opt_state, target, view, vp, focal_x,
                            focal_y, tan_fovx, tan_fovy, *, width: int,
                            height: int, cfg: RenderConfig, mesh: Mesh,
                            optimizer, exch_factor: float = 2.0,
                            lambda_dssim: float = 0.2):
    """One sharded training step on the fast path.

    ``raw`` is ``shard_params`` of a ``trainer.raw_from_params`` dict and
    ``opt_state`` one ``optimizer.init`` per shard (``optimizer`` is
    ``trainer.make_optimizer``); optimisation runs in raw space, as in
    ``train/trainer.py``. The loss is the 3DGS objective
    (1 - lambda) L1 + lambda D-SSIM (``losses.gs_loss``) on the assembled
    image against ``target`` (on ``mesh.out_device``).

    Returns ``(raw, opt_state, loss, stats)``. A nonzero
    ``stats["overflow"]`` means the loss saw an incomplete render: pass the
    stats to ``warn_on_sharded_overflow`` and raise ``exch_factor`` (= D
    guarantees zero exchange drops) or the capacity when it fires."""
    from openglgaussiansplattingrenderer_tpu_torch.train import losses

    def loss_fn(params):
        img, stats = render_fast_sharded(
            params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy, width,
            height, cfg, mesh, exch_factor)
        return losses.gs_loss(img[..., :3], target, lambda_dssim), stats

    return step_sharded(raw, opt_state, optimizer, loss_fn)


def warn_on_sharded_overflow(stats, exch_factor: float, ndev: int) -> int:
    """Warn when a sharded frame or step dropped records, as
    ``Splats._warn_on_overflow`` does for one device: with ``exch_factor <
    D`` a skewed scene can overflow a bucket and train on an incomplete
    render. Reads the count from the device; returns it."""
    ov = int(stats.get("overflow", 0))
    if ov > 0:
        warnings.warn(
            f"sharded step dropped {ov} records (exchange buckets or local "
            f"capacity; exch_factor={exch_factor}): the render is missing "
            f"the farthest duplicates -- raise exch_factor (= {ndev} "
            "guarantees zero exchange drops) or the record capacity",
            RuntimeWarning, stacklevel=2)
    return ov

