"""A multi-device dry run of the port at tiny shapes.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: ``n_devices`` logical shards run, at 64 splats and
64x64 pixels, one ``train_step_fast_sharded`` (the kernels on every
shard, the record exchange by tile owner, the per-owner merge and
composite, the collective-backed backward, Adam in raw space), the q16
sharded render, one data-parallel step and, for an even ``n_devices >=
4``, one step and a short density-controlled fit on the (2, n / 2)
(view x splat) mesh. Every result is checked as the JAX dry run checks
it; any failure raises.

    python3 -m openglgaussiansplattingrenderer_tpu_torch.dryrun 8

On ``device="cuda"`` (the default) the shards lie on the present cards in
turn (``cuda:i % count``, repeats allowed); ``device="cpu"`` puts them all
on the CPU.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


def _devices(n: int, device: str):
    if device == "cpu":
        return ["cpu"] * n
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu'")
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the dry run on ``n_devices`` logical shards; returns its numbers
    (losses, overflow, the alive count after the densify) and prints one
    line saying what ran."""
    from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig
    from openglgaussiansplattingrenderer_tpu_torch.convert import params_from_numpy
    from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io
    from openglgaussiansplattingrenderer_tpu_torch.parallel import data_parallel as dp
    from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs
    from openglgaussiansplattingrenderer_tpu_torch.parallel import mesh2d
    from openglgaussiansplattingrenderer_tpu_torch.parallel import sharded
    from openglgaussiansplattingrenderer_tpu_torch.train import densify as dn
    from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
        TrainConfig,
        camera_bundles,
        make_optimizer,
        params_from_raw,
        raw_from_params,
    )

    devs = _devices(n_devices, device)
    dev0 = torch.device(devs[0])
    mesh = sharded.make_mesh(devices=devs)
    width = height = 64
    cfg = RenderConfig(chunk=32, max_per_tile=256, dup_capacity_factor=16.0)
    scene = ply_io.make_synthetic_scene(64, seed=3, extent=1.5)
    params = sharded.pad_scene_for_mesh(
        params_from_numpy({k: v for k, v in scene.items() if k != "sh_rest"}, dev0),
        n_devices)
    raw = raw_from_params(params)
    cam = Camera(0.0, 0.0, -4.0, width=width, height=height)
    view, vp, *focal = camera_bundles([cam], dev0)[0]
    target = torch.zeros((height, width, 3), dtype=torch.float32, device=dev0)
    out = {"n_devices": n_devices, "devices": devs}

    # ---- one sharded train step (Adam at 1e-3 on every tensor, as optax.adam(1e-3))
    lr = 1e-3
    optimizer = make_optimizer(TrainConfig(lr_means=lr, lr_scales=lr, lr_quats=lr,
                                           lr_opacities=lr, lr_colors=lr))
    raw_sh = sharded.shard_params(raw, mesh)
    raw2, _, loss, stats = fs.train_step_fast_sharded(
        raw_sh, [optimizer.init(r) for r in raw_sh], target, view, vp, *focal,
        width=width, height=height, cfg=cfg, mesh=mesh, optimizer=optimizer)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert int(stats["overflow"]) == 0, f"dryrun dropped records: {stats}"
    params2 = params_from_raw(sharded.gather_shards(raw2, dev0))
    for k, v in params2.items():
        assert bool(torch.isfinite(v).all()), f"non-finite update in {k}"
    qn = torch.linalg.vector_norm(params2["quats"], dim=-1)
    assert bool(((qn - 1.0).abs() < 1e-5).all()), "quats not renormalised"
    out["sharded_step_loss"] = loss

    # ---- the q16 inference mode through the sharded path
    with torch.no_grad():
        qimg, qstats = fs.render_fast_sharded(
            params_from_raw(sharded.gather_shards(raw_sh, dev0)), view, vp, *focal, width,
            height, dataclasses.replace(cfg, depth_key="packed", sort_payload="q16"), mesh)
    assert bool(torch.isfinite(qimg).all()), "q16 sharded render not finite"
    assert int(qstats["overflow"]) == 0

    # ---- view-parallel training: one view a shard, replicated parameters
    cams = [Camera(0.3 * i - 0.5, 0.1, -4.0 - 0.2 * i, width=width, height=height)
            for i in range(n_devices)]
    bundles = camera_bundles(cams, dev0)
    targets = [np.full((height, width, 3), 0.1 * (i % 3), np.float32)
               for i in range(n_devices)]
    keys = tuple(sorted(raw))
    dstep = dp.make_dp_train_step(cfg, TrainConfig(), width, height, mesh, batch=n_devices,
                                  param_keys=keys)
    rep = dp.replicate_tree(raw, mesh)
    raw3, _, dloss, _ = dstep(rep, dstep.init(rep),
                              *dp.stack_view_batch(targets, bundles, dev0))
    dloss = float(dloss)
    assert np.isfinite(dloss), f"non-finite dp loss {dloss}"
    for k, v in params_from_raw(raw3[0]).items():
        assert bool(torch.isfinite(v).all()), f"non-finite dp update in {k}"
    out["dp_step_loss"] = dloss
    msg = (f"dryrun_multichip({n_devices}) on {sorted(set(devs))}: one sharded train "
           f"step ok, loss={loss:.6f}; one data-parallel step ok, loss={dloss:.6f}")

    # ---- both axes composed: the (2, n/2) mesh, then a fit with a densify
    if n_devices >= 4 and n_devices % 2 == 0:
        dv, ds = 2, n_devices // 2
        m2 = mesh2d.make_mesh2d(dv, ds, devices=devs)
        # 8x8 px tiles: at least the 5-px halo, so the step trains the full
        # 3DGS objective (L1 + halo-exchanged D-SSIM)
        cfg2 = dataclasses.replace(cfg, grid_x=8, grid_y=8)
        assert cfg2.num_tiles % ds == 0
        step2 = mesh2d.make_2d_train_step(cfg2, TrainConfig(), width, height, m2, batch=dv,
                                          param_keys=keys)
        rs = mesh2d.shard_raw_2d(raw, m2)
        tgt = torch.stack([torch.from_numpy(mesh2d.tile_target(t, width, height, cfg2)[0])
                           for t in targets[:dv]])
        b2 = bundles[:dv]
        raw4, _, loss2d, _, over2d = step2(
            rs, step2.init(rs), tgt, torch.stack([b[0] for b in b2]),
            torch.stack([b[1] for b in b2]),
            *(torch.tensor([float(b[j]) for b in b2]) for j in (2, 3, 4, 5)))
        loss2d = float(loss2d)
        assert np.isfinite(loss2d), f"non-finite 2d loss {loss2d}"
        assert int(over2d) == 0, "2d dryrun dropped records"
        for k, v in params_from_raw(mesh2d.gather_raw_2d(raw4, dev0)).items():
            assert bool(torch.isfinite(v).all()), f"non-finite 2d update in {k}"

        cap = params["means"].shape[0]
        dc = dn.DensifyConfig(capacity=cap, grad_threshold=1e-9, scene_extent=1.5,
                              start_step=0, interval=1, stop_step=2)
        start = {k: v[:48] for k, v in params.items()}
        fitted, alive, hist = mesh2d.fit_scene_2d(
            start, targets[:dv], cams[:dv], cfg2, TrainConfig(steps=2, lambda_dssim=0.0),
            mesh=m2, batch=dv, dc=dc, seed=0, log_every=1, verbose=False)
        for k, v in fitted.items():
            assert bool(torch.isfinite(v).all()), f"non-finite ADC update in {k}"
        assert all(np.isfinite(h["loss"]) for h in hist) and hist[-1]["overflow"] == 0
        assert int(alive.sum()) == hist[-1]["alive"] > 48, "the densify grew nothing"
        out.update(mesh2d_step_loss=loss2d, mesh2d_fit_alive=hist[-1]["alive"])
        msg += (f"; one 2-D ({dv}x{ds}) view-x-splat step ok, loss={loss2d:.6f}; a 2-D "
                f"fit with one densify ok (alive={hist[-1]['alive']})")
    print(msg)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
