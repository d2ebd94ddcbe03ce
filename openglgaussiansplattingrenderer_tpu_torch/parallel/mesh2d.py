"""2-D mesh training: views x splats, both parallel axes composed.

Counterpart of ``openglgaussiansplattingrenderer_tpu/parallel/mesh2d.py``,
on the port's single-controller meshes (``parallel/sharded.py``).
``parallel/fast_sharded.py`` scales one frame over devices (splat-sharded
table and expansion, record exchange by tile owner, per-owner composite);
``parallel/data_parallel.py`` scales a batch of views (replicated
parameters, one ``pmean``). This module runs both at once on a
``Mesh2D``, a (dv x ds) grid of devices with axes ``VIEW_AXIS`` and
``SPLAT_AXIS``:

- splat shard s is one raw-parameter dict on ``devices[0][s]``; view row r
  reads it through ``.to(devices[r][s])``, so autograd sums the rows'
  gradients into the one shard (the JAX package gets that sum from the
  ``shard_map`` transpose of a view-replicated input). Each row renders
  its views with ``fast_sharded``'s stages 1-3 on its 1-D row mesh (the
  record exchange stays inside the row);
- the loss is the 3DGS objective (1 - lambda) L1 + lambda D-SSIM
  (``losses.gs_loss``), scored per owned tile, with no assembled image.
  L1 is per pixel. D-SSIM's 11x11 window needs a ``HALO`` of 5 px of the
  neighbouring tiles: every owner's border strips go to every owner of the
  row by one ``all_gather``, each owner pads its tiles with them
  (``_padded_tiles``), takes ``losses.ssim_map`` and keeps the windows
  whose centre pixel it owns and whose extent lies inside the image
  (``_window_mask``). One ``psum`` over both axes gives the batch loss;
- tiles are owned round-robin, so a tile's neighbours sit on other
  owners: the prediction's strips arrive owner-major (``row_of`` maps a
  global tile to its row there), the target's are in global tile order,
  and halos outside the grid are zero and masked;
- the densify statistic is the screen-space gradient of a zero shift per
  (view, splat), normed per view in NDC units before the batch sum.
  Density control gathers the shards to ``devices[0][0]``, runs
  ``train.densify.densify_and_prune`` with its ``torch.Generator`` there,
  and shards the result again, as ``fit_scene_dp`` does on replica 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.ops.compositing import padded_dims
from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs
from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import (
    SPLAT_AXIS,
    VIEW_AXIS,
    Mesh2D,
    Params,
    make_mesh2d,
    on_device,
    pad_scene_for_mesh,
)
from openglgaussiansplattingrenderer_tpu_torch.train import losses
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
    TrainConfig,
    make_optimizer,
    params_from_raw,
)

# D-SSIM's 11x11 window reaches 5 px past a tile's edge: the halo width of
# neighbouring tiles' pixels each owner gathers before windowing.
HALO = 5

__all__ = ["make_mesh2d", "tile_target", "shard_raw_2d", "make_2d_train_step",
           "fit_scene_2d", "VIEW_AXIS", "SPLAT_AXIS", "HALO"]


def _padded_tiles(center: torch.Tensor, strips, my_tiles: torch.Tensor, gx: int,
                  gy: int, row_of: Callable) -> torch.Tensor:
    """Halo-padded tiles (tpd, ph + 2h, pw + 2h, C) of the owned tiles
    ``my_tiles`` from the border strips of every tile.

    ``center``: (tpd, ph, pw, C) owned tiles' pixels. ``strips`` = (tops,
    bots, lefts, rights): (rows, h, pw, C) / (rows, ph, h, C) strips of
    every tile, in the caller's row layout (global tile order for the
    target, owner-major ``all_gather`` order for the prediction);
    ``row_of`` maps a global tile id tensor to that layout's row. Halos
    outside the grid are zero; ``_window_mask`` excludes every window that
    could touch them, so the fill never reaches the loss."""
    tops, bots, lefts, rights = strips
    h = tops.shape[1]
    ty, tx = my_tiles // gx, my_tiles % gx

    def nbr(strip, dy, dx, sl=None):
        ny, nx = ty + dy, tx + dx
        ok = (ny >= 0) & (ny < gy) & (nx >= 0) & (nx < gx)
        t2 = ny.clamp(0, gy - 1) * gx + nx.clamp(0, gx - 1)
        s = strip[row_of(t2).long()]
        if sl is not None:
            s = s[:, :, sl]
        return torch.where(ok[:, None, None, None], s, s.new_zeros(()))

    top = torch.cat([nbr(bots, -1, -1, slice(-h, None)), nbr(bots, -1, 0),
                     nbr(bots, -1, 1, slice(None, h))], dim=2)
    bot = torch.cat([nbr(tops, 1, -1, slice(-h, None)), nbr(tops, 1, 0),
                     nbr(tops, 1, 1, slice(None, h))], dim=2)
    mid = torch.cat([nbr(rights, 0, -1), center, nbr(lefts, 0, 1)], dim=2)
    return torch.cat([top, mid, bot], dim=1)


def _tile_strips(tiles4: torch.Tensor):
    """(T, ph, pw, C) -> the four HALO-wide border strips (top, bottom,
    left, right)."""
    return (tiles4[:, :HALO], tiles4[:, -HALO:], tiles4[:, :, :HALO],
            tiles4[:, :, -HALO:])


def _window_mask(my_tiles: torch.Tensor, gx: int, ph: int, pw: int, width: int,
                 height: int) -> torch.Tensor:
    """(tpd, ph, pw) float mask of the SSIM windows whose centre pixel lies
    in the owned tiles and whose 11x11 extent stays inside the true image:
    over all tiles it selects exactly the (height - 10) x (width - 10)
    valid windows ``losses.ssim`` means over (pad pixels past the image and
    zero halos outside the grid are never reached)."""
    h = HALO
    dev = my_tiles.device
    ty, tx = my_tiles // gx, my_tiles % gx
    gy_pix = ty[:, None] * ph + torch.arange(ph, dtype=torch.int32, device=dev)[None, :]
    gx_pix = tx[:, None] * pw + torch.arange(pw, dtype=torch.int32, device=dev)[None, :]
    okr = (gy_pix >= h) & (gy_pix < height - h)
    okc = (gx_pix >= h) & (gx_pix < width - h)
    return (okr[:, :, None] & okc[:, None, :]).to(torch.float32)


def tile_target(target, width: int, height: int, cfg: RenderConfig
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) target -> ((T, P, 3) tiles, (T, P) valid-pixel mask), numpy.

    Tile t = ty * grid_x + tx, as ``compositing.assemble_image`` lays them
    out; the mask zeroes the pad pixels the compositor renders but
    ``assemble_image`` crops."""
    if torch.is_tensor(target):
        target = target.detach().cpu().numpy()
    wp, hp = padded_dims(width, height, cfg)
    gx, gy = cfg.grid_x, cfg.grid_y
    pw, ph = wp // gx, hp // gy
    t = np.zeros((hp, wp, 3), np.float32)
    t[:height, :width] = np.asarray(target, np.float32)
    m = np.zeros((hp, wp), np.float32)
    m[:height, :width] = 1.0
    tiles = t.reshape(gy, ph, gx, pw, 3).transpose(0, 2, 1, 3, 4)
    mask = m.reshape(gy, ph, gx, pw).transpose(0, 2, 1, 3)
    return tiles.reshape(gy * gx, ph * pw, 3), mask.reshape(gy * gx, ph * pw)


def shard_raw_2d(raw, mesh: Mesh2D) -> List[Params]:
    """Raw parameters as one dict per splat shard, shard s on
    ``mesh.devices[0][s]``: a global dict is split into contiguous row
    blocks (its row count divisible by ds: ``pad_scene_for_mesh``); a list
    of per-shard dicts is placed again."""
    ds = mesh.shape[SPLAT_AXIS]
    if isinstance(raw, dict):
        n = raw["means"].shape[0]
        if n % ds:
            raise ValueError(f"{n} splats not divisible by {ds} splat shards; use "
                             "pad_scene_for_mesh")
        m = n // ds
        raw = [{k: v[s * m:(s + 1) * m] for k, v in raw.items()} for s in range(ds)]
    if len(raw) != ds:
        raise ValueError(f"{len(raw)} parameter shards for {ds} splat shards")
    return [{k: v.detach().to(dev) for k, v in r.items()}
            for r, dev in zip(raw, mesh.devices[0])]


def gather_raw_2d(raw: List[Params], device) -> Params:
    """Per-shard dicts -> one global dict on ``device`` (shard order)."""
    return {k: torch.cat([r[k].to(device) for r in raw]) for k in raw[0]}


def _place_state_2d(opt_state: dict, mesh: Mesh2D, capacity: int) -> List[dict]:
    """A global Adam state (``{"count", "mu", "nu"}``) as one state per
    splat shard: moments with ``capacity`` leading rows split as
    ``shard_raw_2d`` splits the parameters, the step count on every
    shard. The re-placing after a densify or a resume."""
    ds = mesh.shape[SPLAT_AXIS]
    m = capacity // ds
    out = []
    for s, dev in enumerate(mesh.devices[0]):
        st = {"count": opt_state["count"]}
        for part in ("mu", "nu"):
            st[part] = {k: (v[s * m:(s + 1) * m] if v.shape[0] == capacity else v).to(dev)
                        for k, v in opt_state[part].items()}
        out.append(st)
    return out


def _gather_state_2d(states: List[dict], device) -> dict:
    return {"count": states[0]["count"],
            **{part: {k: torch.cat([st[part][k].to(device) for st in states])
                      for k in states[0][part]} for part in ("mu", "nu")}}


def _host_floats(x) -> List[float]:
    """A (B,) camera scalar column as Python floats, float32-rounded."""
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).cpu().tolist()
    return np.asarray(x, np.float32).tolist()


def make_2d_train_step(cfg: RenderConfig, tc: TrainConfig, width: int,
                       height: int, mesh: Mesh2D, *, batch: Optional[int] = None,
                       param_keys=None, exch_factor: float = 2.0,
                       with_grad_norms: bool = False):
    """Train step on the (view x splat) mesh.

    ``batch`` views per optimizer step (default: one per view row; a
    multiple of dv, each row rendering ``batch // dv`` views). The loss is
    the batch mean of the per-view 3DGS objective (``losses.gs_loss``): L1
    per owned tile, D-SSIM on halo-padded tiles after a border-strip
    ``all_gather``; ``tc.lambda_dssim = 0`` skips the halo exchange.

    Step signature::

        step(raw, opt_state, tgt_tiles (B, T, P, 3), view (B, 4, 4),
             vp (B, 4, 4), fx, fy, tfx, tfy (B,))
        -> (raw, opt_state, loss, psnr, overflow[, gnorm (N,), seen (N,)])

    ``raw`` is ``shard_raw_2d``'s list (rows divisible by ds:
    ``pad_scene_for_mesh``), ``opt_state`` one state per shard
    (``step.init(raw)``), targets from ``tile_target``. Loss, PSNR (the
    mean of per-view PSNRs) and overflow (summed over both axes) lie on
    ``mesh.devices[0][0]``. ``with_grad_norms`` adds the screen-space
    densify statistic summed over the batch's views, each view's normed
    first and taken of the view's own loss (the batch-mean loss gives 1/B
    of it), and the number of views in which each splat had a gradient, as
    global (N,) tensors on ``mesh.devices[0][0]``: a batch-B step advances
    the densify accumulators as B sequential view-iterations do.
    """
    dv, ds = mesh.shape[VIEW_AXIS], mesh.shape[SPLAT_AXIS]
    batch = batch or dv
    if batch % dv:
        raise ValueError(f"batch {batch} not a multiple of view rows {dv}")
    local_bs = batch // dv
    if cfg.num_tiles % ds:
        raise ValueError(f"{cfg.num_tiles} tiles not divisible by {ds} splat shards")
    tpd = cfg.num_tiles // ds
    optimizer = (make_optimizer(tc) if param_keys is None
                 else make_optimizer(tc, keys=param_keys))
    keys = optimizer.keys
    _, mask_np = tile_target(np.zeros((height, width, 3), np.float32), width, height, cfg)
    npix_valid = float(mask_np.sum())
    wp, hp = padded_dims(width, height, cfg)
    pw, ph = wp // cfg.grid_x, hp // cfg.grid_y
    gx, gy = cfg.grid_x, cfg.grid_y
    use_dssim = bool(tc.lambda_dssim)
    if use_dssim and min(ph, pw) < HALO:
        raise ValueError(
            f"D-SSIM on the 2-D mesh needs tiles >= {HALO} px (got {pw}x{ph}); use "
            "tc.lambda_dssim=0 or a coarser grid")
    if use_dssim and (height <= 2 * HALO or width <= 2 * HALO):
        raise ValueError(f"D-SSIM needs images > {2 * HALO} px, got {width}x{height}")
    nwin = float((height - 2 * HALO) * (width - 2 * HALO) * 3)
    dev0 = mesh.devices[0][0]
    consts = {}

    def on(dev):
        """Per device: (valid-pixel mask (T, P), background (3,)), made once."""
        if dev not in consts:
            consts[dev] = (torch.from_numpy(mask_np).to(dev),
                           torch.tensor(cfg.background, dtype=torch.float32, device=dev))
        return consts[dev]

    def row_terms(r, row, raw_row, shifts, tgt, view, vp, cam):
        """The row's per-view sums over its owners: (l1, se, ssim) lists of
        per-shard scalars a view, and the row's overflow."""
        views, over = [], None
        for j in range(local_bs):
            v = r * local_bs + j
            params = []
            for s, (_, dev) in enumerate(row.local):
                p = params_from_raw(raw_row[s])
                if shifts is not None:
                    p["shift2d"] = shifts[v][s]
                params.append(p)
            tiled, stats = fs.render_tiles(params, view[v], vp[v], *(c[v] for c in cam),
                                           width, height, cfg, row, exch_factor)
            over = stats["overflow"] if over is None else over + stats["overflow"]
            l1, se, rgbs, mine, tgts = [], [], [], [], []
            for (d, dev), til in zip(row.local, tiled):
                with on_device(dev):
                    mask, bg = on(dev)
                    my = fs.owned_tiles(d, ds, tpd, dev)
                    tgt_v = tgt[v].to(dev)
                    rgb = til[:, :, 0:3] / cfg.color_scale + til[:, :, 3:4] * bg
                    diff = rgb - tgt_v[my.long()]
                    m_own = mask[my.long()][..., None]
                    se.append(torch.sum(diff * diff * m_own))
                    l1.append(torch.sum(torch.abs(diff) * m_own))
                    rgbs.append(rgb.reshape(tpd, ph, pw, 3))
                    mine.append(my)
                    tgts.append(tgt_v.reshape(cfg.num_tiles, ph, pw, 3))
            ssim = []
            if use_dssim:
                # the halo exchange: every owner's border strips to every
                # owner of the row (owner-major), then halo-padded windows
                pstrips = [row.all_gather(list(parts))
                           for parts in zip(*(_tile_strips(x) for x in rgbs))]
                for i, (_, dev) in enumerate(row.local):
                    with on_device(dev):
                        pred_pad = _padded_tiles(
                            rgbs[i], tuple(p[i] for p in pstrips), mine[i], gx, gy,
                            lambda t2: (t2 % ds) * tpd + t2 // ds)
                        tgt_pad = _padded_tiles(
                            tgts[i][mine[i].long()], _tile_strips(tgts[i]), mine[i], gx,
                            gy, lambda t2: t2)
                        m_win = _window_mask(mine[i], gx, ph, pw, width, height)
                        smap = losses.ssim_map(pred_pad, tgt_pad)
                        ssim.append(torch.sum(smap * m_win[..., None]))
            views.append((l1, se, ssim))
        return views, over

    def step(raw: List[Params], opt_state: List[dict], tgt, view, vp, fx, fy, tfx, tfy):
        if len(raw) != ds or len(opt_state) != ds:
            raise ValueError(f"raw and opt_state need one entry per splat shard ({ds})")
        cam = [_host_floats(c) for c in (fx, fy, tfx, tfy)]
        leaves = [{k: r[k].detach().requires_grad_(True) for k in keys} for r in raw]
        shifts = None
        if with_grad_norms:
            shifts = [[torch.zeros((leaves[s]["means"].shape[0], 2), dtype=torch.float32,
                                   device=mesh.devices[v // local_bs][s], requires_grad=True)
                       for s in range(ds)] for v in range(batch)]
        per_row, overs = [], []
        for r, row in enumerate(mesh.rows):
            raw_row = [{k: leaves[s][k].to(dev) for k in keys}
                       for s, (_, dev) in enumerate(row.local)]
            views, over = row_terms(r, row, raw_row, shifts, tgt, view, vp, cam)
            per_row.append(views)
            overs.append(over)

        def both_axes(which):
            """One psum over both axes of each (row, shard)'s sum over the
            row's views of term ``which``."""
            xss = [[sum(vw[which][s] for vw in views) for s in range(ds)]
                   for views in per_row]
            return mesh.psum(xss)[0][0]

        l1_mean = both_axes(0) / (batch * npix_valid * 3.0)
        if use_dssim:
            ssim_mean = both_axes(2) / (batch * nwin)
            loss = ((1.0 - tc.lambda_dssim) * l1_mean
                    + tc.lambda_dssim * (1.0 - ssim_mean) / 2.0)
        else:
            loss = l1_mean
        with torch.no_grad():
            # the mean of per-view PSNRs, as fit_scene / data_parallel log it
            psnrs = []
            for row, views in zip(mesh.rows, per_row):
                for vw in views:
                    mse = row.psum([x.detach() for x in vw[1]])[0] / (npix_valid * 3.0)
                    psnrs.append((-10.0 * torch.log10(torch.clamp_min(mse, 1e-12))).to(dev0))
            psnr = torch.stack(psnrs).mean()
            overflow = overs[0].to(dev0)
            for x in overs[1:]:
                overflow = overflow + x.to(dev0)

        wrt = [leaves[s][k] for s in range(ds) for k in keys]
        if with_grad_norms:
            wrt += [x for row in shifts for x in row]
        gs = torch.autograd.grad(loss, wrt)
        new_raw, new_opt = [], []
        with torch.no_grad():
            for s, (dev, st) in enumerate(zip(mesh.devices[0], opt_state)):
                with on_device(dev):
                    g = dict(zip(keys, gs[s * len(keys):(s + 1) * len(keys)]))
                    r, st = optimizer.update(
                        g, st, {k: leaves[s][k].detach() for k in keys})
                    new_raw.append(r)
                    new_opt.append(st)
            if not with_grad_norms:
                return new_raw, new_opt, loss.detach(), psnr, overflow
            # the loss is the batch mean, so view v's shift gradient is
            # 1/B of its own loss's: scaled back, each norm is the view's
            # statistic, and the sum is B view-iterations' (as
            # data_parallel's; the JAX package's 2-D step sums the 1/B norms)
            gshift = gs[ds * len(keys):]
            gnorm = seen = None
            for v in range(batch):
                g = torch.cat([gshift[v * ds + s].to(dev0) for s in range(ds)])
                nrm = torch.linalg.vector_norm(
                    g * g.new_tensor([batch * width / 2.0, batch * height / 2.0]), dim=-1)
                gnorm = nrm if gnorm is None else gnorm + nrm
                hit = (nrm > 0.0).to(torch.float32)
                seen = hit if seen is None else seen + hit
        return new_raw, new_opt, loss.detach(), psnr, overflow, gnorm, seen

    step.init = lambda raw: [optimizer.init(r) for r in raw]
    step.optimizer = optimizer
    return step


def fit_scene_2d(params, targets, cameras, cfg: RenderConfig,
                 tc: Optional[TrainConfig] = None, *, mesh: Mesh2D,
                 batch: Optional[int] = None, width: Optional[int] = None,
                 height: Optional[int] = None, exch_factor: float = 2.0,
                 dc=None, seed: int = 0,
                 save_every: int = 0, checkpoint_path: Optional[str] = None,
                 resume: Optional[str] = None,
                 log_every: int = 50, verbose: bool = True):
    """``trainer.fit_scene`` on the (view x splat) mesh.

    The splat parameters are padded to a multiple of ds and sharded; each
    optimizer step takes ``batch`` views (default: one per view row),
    cycling through the view list. Returns (activated params on
    ``mesh.devices[0][0]``, history) like ``fit_scene``, history entries
    {step, loss, psnr, overflow[, alive], wall_s}; a step that dropped
    records warns (``fast_sharded.warn_on_sharded_overflow``).

    ``dc`` (a ``train.densify.DensifyConfig``) adds adaptive density
    control: the parameters live at ``dc.capacity`` rows (rounded up to a
    multiple of ds), the step returns the per-view screen statistic, and
    every ``dc.interval`` steps the shards are gathered to
    ``devices[0][0]``, ``densify_and_prune`` runs there with its
    ``torch.Generator``, and the result is sharded again, so a run on a dv
    x ds mesh equals the run on a 1 x 1 mesh to float tolerance where no
    densify decision sits within rounding of its threshold or of another
    candidate's rank (at millions of splats some do: the two meshes sum in
    other orders). With ``dc`` the return is (params at capacity, alive
    mask, history).

    ``save_every`` / ``checkpoint_path`` / ``resume`` as in
    ``trainer.fit_scene``: checkpoints hold the gathered state in the npz
    format of ``trainer.save_checkpoint`` (with ``dc``, also the densify
    state and the generator's state); resume shards it again, so a killed
    run replays the uninterrupted one exactly.
    """
    from openglgaussiansplattingrenderer_tpu_torch import convert
    from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
    from openglgaussiansplattingrenderer_tpu_torch.train import trainer

    tc = tc or TrainConfig()
    dv, ds = mesh.shape[VIEW_AXIS], mesh.shape[SPLAT_AXIS]
    dev = mesh.devices[0][0]
    batch = batch or dv
    width = width or trainer.camera_dims(cameras[0])[0]
    height = height or trainer.camera_dims(cameras[0])[1]

    params = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                 dtype=torch.float32).to(dev)
              for k, v in params.items() if v is not None}
    n_orig = params["means"].shape[0]
    alive = grad_accum = seen_count = gen = None
    with torch.no_grad():
        if dc is not None:
            cap = -(-dc.capacity // ds) * ds
            if cap != dc.capacity:
                dc = dataclasses.replace(dc, capacity=cap)
            raw, alive = dn.pad_to_capacity(trainer.raw_from_params(params), cap)
            grad_accum = torch.zeros(cap, dtype=torch.float32, device=dev)
            seen_count = torch.zeros(cap, dtype=torch.float32, device=dev)
            gen = dn._seeded_generator(dev, seed, 0)
        else:
            raw = trainer.raw_from_params(pad_scene_for_mesh(params, ds))
    step = make_2d_train_step(cfg, tc, width, height, mesh, batch=batch,
                              param_keys=tuple(sorted(raw.keys())),
                              exch_factor=exch_factor, with_grad_norms=dc is not None)
    opt_state = step.optimizer.init(raw)
    start_step = 0
    if resume:
        r_raw, start_step, extras = trainer.load_checkpoint_full(resume)
        trainer.check_resume_shapes(raw, r_raw, resume)
        if "opt_leaves" in extras:       # written by the JAX package
            state = convert.train_state_from_checkpoint(resume, tc, dev)
            raw, opt_state = state.raw, state.opt_state
        else:
            raw = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                   for k, v in r_raw.items()}
            if "opt_state" in extras:
                opt_state = trainer.restore_opt_state(opt_state, extras["opt_state"])
        if dc is not None:
            if "alive" not in extras:
                raise ValueError(
                    f"resume checkpoint {resume!r} carries no densify state "
                    "(alive/grad_accum/...) -- was it saved from a run without "
                    "adaptive density control?")
            alive = torch.as_tensor(extras["alive"], dtype=torch.bool).to(dev)
            grad_accum = torch.as_tensor(extras["grad_accum"], dtype=torch.float32).to(dev)
            seen_count = torch.as_tensor(extras["seen_count"], dtype=torch.float32).to(dev)
            if "rng_state" in extras:
                gen.set_state(torch.as_tensor(extras["rng_state"], dtype=torch.uint8))
            else:
                gen = dn._seeded_generator(dev, seed, start_step)
        if verbose:
            print(f"resumed {resume} at step {start_step}")
    rows = raw["means"].shape[0]
    raw_sh, opt_sh = shard_raw_2d(raw, mesh), _place_state_2d(opt_state, mesh, rows)
    del raw, opt_state
    bundles = trainer.camera_bundles(cameras, dev)
    tgt_tiles = [torch.from_numpy(tile_target(t, width, height, cfg)[0]).to(dev)
                 for t in targets]

    def gathered():
        return gather_raw_2d(raw_sh, dev), _gather_state_2d(opt_sh, dev)

    t0 = time.time()
    history = []
    nv = len(targets)
    for i in range(start_step, tc.steps):
        sel = [(i * batch + j) % nv for j in range(batch)]
        bsel = [bundles[s] for s in sel]
        args = (torch.stack([tgt_tiles[s] for s in sel]),
                torch.stack([b[0] for b in bsel]), torch.stack([b[1] for b in bsel]),
                *(torch.tensor([float(b[j]) for b in bsel], dtype=torch.float32)
                  for j in (2, 3, 4, 5)))
        if dc is None:
            raw_sh, opt_sh, loss, p, over = step(raw_sh, opt_sh, *args)
        else:
            raw_sh, opt_sh, loss, p, over, gnorm, seen = step(raw_sh, opt_sh, *args)
            grad_accum, seen_count = dn.accumulate_grad_stats_batched(
                grad_accum, seen_count, gnorm, seen, alive)
            if dc.densifies_at(i):
                raw, opt_state = gathered()
                raw, alive, changed, dstats = dn.densify_and_prune(
                    raw, alive, grad_accum, seen_count, dc, generator=gen, iteration=i)
                raw_sh = shard_raw_2d(raw, mesh)
                opt_sh = _place_state_2d(dn.reset_rows(opt_state, changed), mesh,
                                         dc.capacity)
                grad_accum = torch.zeros_like(grad_accum)
                seen_count = torch.zeros_like(seen_count)
                if verbose:
                    print(f"step {i}: densify { {k: int(v) for k, v in dstats.items()} }")
            if dc.resets_opacity_at(i):
                raw, opt_state = gathered()
                raw_sh = shard_raw_2d(dn.reset_opacity(raw, dc.opacity_reset_ceiling), mesh)
                opt_sh = _place_state_2d(dn.reset_opacity_moments(opt_state, dc.capacity),
                                         mesh, dc.capacity)
        if i % log_every == 0 or i == tc.steps - 1:
            # float(...) waits for the queued steps, so wall_s is honest
            m = {"loss": float(loss), "psnr": float(p), "overflow": int(over)}
            if dc is not None:
                m["alive"] = int(alive.sum())
            fs.warn_on_sharded_overflow({"overflow": m["overflow"]}, exch_factor, ds)
            history.append({"step": i, **m, "wall_s": round(time.time() - t0, 3)})
            if verbose:
                print(f"step {i}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                      f"(batch {batch}, mesh {dv}x{ds})")
        if (save_every and checkpoint_path
                and ((i + 1) % save_every == 0 or i == tc.steps - 1)):
            raw, opt_state = gathered()
            extras = {}
            if dc is not None:
                extras = dict(alive=alive, grad_accum=grad_accum, seen_count=seen_count,
                              rng_state=gen.get_state())
            trainer.save_checkpoint(checkpoint_path, raw, step=i + 1,
                                    opt_state=opt_state, **extras)
    with torch.no_grad():
        fitted = params_from_raw(gather_raw_2d(raw_sh, dev))
    if dc is not None:
        return fitted, alive, history
    # strip the splat-axis padding added above
    return {k: v[:n_orig] for k, v in fitted.items()}, history
