"""View-parallel (data-parallel) training: views sharded, gradients averaged.

Counterpart of ``openglgaussiansplattingrenderer_tpu/parallel/data_parallel.py``,
on the port's single-controller mesh (``parallel/sharded.py``). The
splat-sharded fast path scales ONE frame over devices; 3DGS training more
commonly scales the other axis: a batch of training views per optimizer
step, ``batch // D`` views a shard, the splat parameters and the Adam state
replicated. Each shard renders its views with the unmodified single-device
path (``render_arrays``: kernels 1-5 on the card), takes its local
gradients, and one ``pmean`` gives every replica the batch-mean gradient,
so the update is the same on each. A shard backpropagates each view before
it renders the next, so memory holds one view's graph.

The reference is strictly single-GPU and has no training at all; this
layer is capability on top.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from openglgaussiansplattingrenderer_tpu_torch.config import RenderConfig
from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import (
    Mesh,
    make_mesh,
    on_device,
    pmean,
    psum,
)
from openglgaussiansplattingrenderer_tpu_torch.render import render_arrays
from openglgaussiansplattingrenderer_tpu_torch.train import losses
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
    TrainConfig,
    make_optimizer,
    params_from_raw,
)

__all__ = ["make_mesh", "stack_view_batch", "make_dp_train_step",
           "replicate_tree", "fit_scene_dp"]


def stack_view_batch(targets, bundles, device) -> Tuple[torch.Tensor, ...]:
    """(targets list, camera bundles list) -> the batched step arguments on
    ``device``: targets (B, H, W, 3), view (B, 4, 4), vp (B, 4, 4) and fx,
    fy, tfx, tfy each (B,), float32. ``bundles`` are
    ``trainer.camera_bundles`` tuples."""
    def stack(xs):
        return torch.stack([torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                            else x, dtype=torch.float32).to(device)
                            for x in xs])

    return (stack(targets), stack([b[0] for b in bundles]),
            stack([b[1] for b in bundles]),
            *(stack([b[i] for b in bundles]) for i in (2, 3, 4, 5)))


def replicate_tree(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` (nested dicts of tensors and plain values) per
    shard, on the shard's device; shards that share a device share the
    tensors."""
    def to(x, dev):
        if torch.is_tensor(x):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: to(v, dev) for k, v in x.items()}
        return x

    return [to(tree, dev) for dev in mesh.devices]


def make_dp_train_step(cfg: RenderConfig, tc: TrainConfig, width: int,
                       height: int, mesh: Mesh, *, batch: int,
                       param_keys=None, with_grad_norms: bool = False):
    """Data-parallel train step over a ``batch`` of views.

    ``batch`` must be a multiple of the mesh size; shard d renders views
    [d * batch/D, (d + 1) * batch/D) in turn and contributes the mean of its
    local gradients to one ``pmean``. The optimizer update then runs on
    every replica with the same gradient, so the replicas stay equal.

    Step signature: ``(raw, opt_state, targets (B,H,W,3), view (B,4,4),
    vp (B,4,4), fx, fy, tfx, tfy (B,)) -> (raw, opt_state, loss, psnr
    [, densify_grad_norm, seen])``, with ``raw`` and ``opt_state`` one
    replica per shard (``replicate_tree``; ``step.init(raw)`` makes the
    optimizer state) and the batch arguments from ``stack_view_batch``.
    Loss and PSNR are batch means on ``mesh.devices[0]``. With
    ``with_grad_norms``, the per-splat screen-space statistic (see
    ``trainer.make_train_step``) is SUMMED over the batch's views -- a
    batch of B counts as B view-iterations toward the densification
    accumulators, as B sequential steps do -- with ``seen``, the number of
    the batch's views in which each splat had a gradient
    (``densify.accumulate_grad_stats_batched`` takes both).
    """
    ndev = mesh.size
    if batch % ndev:
        raise ValueError(f"batch {batch} not a multiple of mesh size {ndev}")
    local_bs = batch // ndev
    optimizer = (make_optimizer(tc) if param_keys is None
                 else make_optimizer(tc, keys=param_keys))
    keys = optimizer.keys

    def shard_grads(dev, raw, views):
        """(gradient dict, loss sum, psnr sum, grad norm sum, seen) of one
        shard's views, each backpropagated before the next is rendered."""
        leaves = {k: raw[k].detach().requires_grad_(True) for k in keys}
        n = leaves["means"].shape[0]
        acc = {k: torch.zeros_like(v) for k, v in leaves.items()}
        gnorm = torch.zeros(n, dtype=torch.float32, device=dev)
        seen = torch.zeros(n, dtype=torch.float32, device=dev)
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        psnr_acc = torch.zeros((), dtype=torch.float32, device=dev)
        scale = torch.tensor([width / 2.0, height / 2.0], device=dev)
        for target, view, vp, fx, fy, tfx, tfy in views:
            params = params_from_raw(leaves)
            wrt = [leaves[k] for k in keys]
            if with_grad_norms:
                shift = torch.zeros((n, 2), dtype=torch.float32, device=dev,
                                    requires_grad=True)
                params["shift2d"] = shift
                wrt.append(shift)
            img, _ = render_arrays(params, view, vp, fx, fy, tfx, tfy, width,
                                   height, cfg)
            pred = img[..., :3]
            loss = losses.gs_loss(pred, target, tc.lambda_dssim)
            gs = torch.autograd.grad(loss, wrt)
            with torch.no_grad():
                for k, g in zip(keys, gs):
                    acc[k] += g
                if with_grad_norms:
                    nrm = torch.linalg.vector_norm(gs[-1] * scale, dim=-1)
                    gnorm += nrm
                    seen += nrm > 0.0
                loss_acc += loss.detach()
                psnr_acc += losses.psnr(pred.detach(), target)
        return acc, loss_acc, psnr_acc, gnorm, seen

    def step(raw: List[Dict[str, torch.Tensor]], opt_state: List[dict], targets,
             view, vp, fx, fy, tfx, tfy):
        if len(raw) != ndev or len(opt_state) != ndev:
            raise ValueError(f"raw and opt_state need one replica per shard ({ndev})")
        per_shard = []
        for d, dev in enumerate(mesh.devices):
            with on_device(dev):
                views = [tuple(x[j].to(dev) for x in (targets, view, vp, fx, fy, tfx, tfy))
                         for j in range(d * local_bs, (d + 1) * local_bs)]
                per_shard.append(shard_grads(dev, raw[d], views))
        with torch.no_grad():
            # the batch-mean gradient: each shard's local mean, averaged
            grads = {k: pmean([s[0][k] / local_bs for s in per_shard], mesh)
                     for k in keys}
            loss_m = pmean([s[1] / local_bs for s in per_shard], mesh)[0]
            psnr_m = pmean([s[2] / local_bs for s in per_shard], mesh)[0]
            new_raw, new_opt = [], []
            for d, dev in enumerate(mesh.devices):
                with on_device(dev):
                    r, st = optimizer.update({k: grads[k][d] for k in keys},
                                             opt_state[d], raw[d])
                    new_raw.append(r)
                    new_opt.append(st)
            if with_grad_norms:
                gnorm = psum([s[3] for s in per_shard], mesh)[0]
                seen = psum([s[4] for s in per_shard], mesh)[0]
                return new_raw, new_opt, loss_m, psnr_m, gnorm, seen
        return new_raw, new_opt, loss_m, psnr_m

    step.init = lambda raw: [optimizer.init(r) for r in raw]
    step.optimizer = optimizer
    return step


def fit_scene_dp(params: Dict[str, torch.Tensor], targets, cameras,
                 cfg: RenderConfig, tc: Optional[TrainConfig] = None,
                 *, mesh: Optional[Mesh] = None, batch: Optional[int] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 dc=None, seed: int = 0,
                 save_every: int = 0, checkpoint_path: Optional[str] = None,
                 resume: Optional[str] = None,
                 log_every: int = 50, verbose: bool = True):
    """``trainer.fit_scene`` with view-parallel batching on ``mesh`` (default:
    every CUDA device; ``make_mesh`` raises without one).

    Each optimizer step consumes ``batch`` views (default: one per shard),
    cycling through the view list, so ``tc.steps`` steps see ``steps *
    batch`` view-iterations. Returns (activated params, history) like
    ``fit_scene``; history entries are {step, loss, psnr[, alive], wall_s}.

    ``dc`` (a ``train.densify.DensifyConfig``) adds adaptive density
    control: the parameters are padded to ``dc.capacity`` and replicated,
    the step also returns the batch-summed screen statistic and the seen
    counts, and ``densify_and_prune`` runs on replica 0's state every
    ``dc.interval`` steps, whose result is replicated again (a batch-B
    interval spans B x interval view-iterations). With ``dc`` the return is
    (params at capacity, alive mask, history), as ``fit_scene_adaptive``'s.

    ``save_every`` / ``checkpoint_path`` / ``resume`` as in
    ``trainer.fit_scene``: replica 0's state goes through the same npz
    format (with ``dc``, also the densify state and the generator's state),
    so a killed run resumes and replays the uninterrupted one exactly.
    """
    from openglgaussiansplattingrenderer_tpu_torch import convert
    from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
    from openglgaussiansplattingrenderer_tpu_torch.train import trainer

    tc = tc or TrainConfig()
    mesh = mesh if mesh is not None else make_mesh()
    dev = mesh.devices[0]
    batch = batch or mesh.size
    width = width or trainer.camera_dims(cameras[0])[0]
    height = height or trainer.camera_dims(cameras[0])[1]

    with torch.no_grad():
        raw = trainer.raw_from_params({
            k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=torch.float32).to(dev)
            for k, v in params.items() if v is not None})
    alive = grad_accum = seen_count = gen = None
    if dc is not None:
        raw, alive = dn.pad_to_capacity(raw, dc.capacity)
        grad_accum = torch.zeros(dc.capacity, dtype=torch.float32, device=dev)
        seen_count = torch.zeros(dc.capacity, dtype=torch.float32, device=dev)
        gen = dn._seeded_generator(dev, seed, 0)
    step = make_dp_train_step(cfg, tc, width, height, mesh, batch=batch,
                              param_keys=tuple(sorted(raw.keys())),
                              with_grad_norms=dc is not None)
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
                    "(alive/grad_accum/...) -- was it saved from a run "
                    "without adaptive density control?")
            alive = torch.as_tensor(extras["alive"], dtype=torch.bool).to(dev)
            grad_accum = torch.as_tensor(extras["grad_accum"],
                                         dtype=torch.float32).to(dev)
            seen_count = torch.as_tensor(extras["seen_count"],
                                         dtype=torch.float32).to(dev)
            if "rng_state" in extras:
                gen.set_state(torch.as_tensor(extras["rng_state"], dtype=torch.uint8))
            else:
                gen = dn._seeded_generator(dev, seed, start_step)
        if verbose:
            print(f"resumed {resume} at step {start_step}")
    raw, opt_state = replicate_tree(raw, mesh), replicate_tree(opt_state, mesh)
    bundles = trainer.camera_bundles(cameras, dev)
    targets = [torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t,
                               dtype=torch.float32).to(dev) for t in targets]

    t0 = time.time()
    history = []
    nv = len(targets)
    for i in range(start_step, tc.steps):
        sel = [(i * batch + j) % nv for j in range(batch)]
        args = stack_view_batch([targets[s] for s in sel],
                                [bundles[s] for s in sel], dev)
        if dc is None:
            raw, opt_state, loss, p = step(raw, opt_state, *args)
        else:
            raw, opt_state, loss, p, gnorm, seen = step(raw, opt_state, *args)
            grad_accum, seen_count = dn.accumulate_grad_stats_batched(
                grad_accum, seen_count, gnorm, seen, alive)
            if dc.densifies_at(i):
                new_raw, alive, changed, dstats = dn.densify_and_prune(
                    raw[0], alive, grad_accum, seen_count, dc, generator=gen, iteration=i)
                raw = replicate_tree(new_raw, mesh)
                opt_state = replicate_tree(dn.reset_rows(opt_state[0], changed), mesh)
                grad_accum = torch.zeros_like(grad_accum)
                seen_count = torch.zeros_like(seen_count)
                if verbose:
                    print(f"step {i}: densify { {k: int(v) for k, v in dstats.items()} }")
            if dc.resets_opacity_at(i):
                raw = replicate_tree(dn.reset_opacity(raw[0], dc.opacity_reset_ceiling),
                                     mesh)
                opt_state = replicate_tree(
                    dn.reset_opacity_moments(opt_state[0], dc.capacity), mesh)
        if i % log_every == 0 or i == tc.steps - 1:
            # float(...) waits for the queued steps, so wall_s is honest
            m = {"loss": float(loss), "psnr": float(p)}
            if dc is not None:
                m["alive"] = int(alive.sum())
            history.append({"step": i, **m, "wall_s": round(time.time() - t0, 3)})
            if verbose:
                print(f"step {i}: loss {m['loss']:.5f} psnr {m['psnr']:.2f} "
                      f"(batch {batch})")
        if (save_every and checkpoint_path
                and ((i + 1) % save_every == 0 or i == tc.steps - 1)):
            extras = {}
            if dc is not None:
                extras = dict(alive=alive, grad_accum=grad_accum,
                              seen_count=seen_count, rng_state=gen.get_state())
            trainer.save_checkpoint(checkpoint_path, raw[0], step=i + 1,
                                    opt_state=opt_state[0], **extras)
    with torch.no_grad():
        out = params_from_raw(raw[0])
    if dc is not None:
        return out, alive, history
    return out, history
