"""A rank of the port's process-group test (``tests/test_torch_multihost.py``).

Run by ``multihost.spawn`` as ``python _torch_multihost_worker.py <outdir>``
with torchrun's environment; joins the group over gloo on the CPU, holds
only its own rows of the scene (``host_local_params``) and, on the process
mesh: renders the fast sharded frame (rank 0 saves it), takes the gradients
of the 3DGS loss against a seeded target with respect to its rows (each
rank saves its own), and runs one ``train_step_fast_sharded`` (rank 0 saves
the loss). Writes ``ok<rank>`` last.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openglgaussiansplattingrenderer_tpu_torch import Camera, RenderConfig  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.io import ply as ply_io  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.parallel import multihost  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import (  # noqa: E402
    pad_scene_for_mesh,
)
from openglgaussiansplattingrenderer_tpu_torch.render import camera_args  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.train import losses  # noqa: E402
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig,
    make_optimizer,
    params_from_raw,
    raw_from_params,
)

W = H = 64
CFG = RenderConfig(chunk=32, dup_capacity_factor=16.0)
N_SPLATS, SEED = 64, 11


def scene(world: int):
    """The padded scene (every rank makes it; each keeps its own rows),
    the camera arguments and the target, all on the CPU."""
    sc = ply_io.make_synthetic_scene(N_SPLATS, seed=SEED, extent=1.5)
    params = pad_scene_for_mesh({k: torch.as_tensor(v) for k, v in sc.items()
                                 if k != "sh_rest"}, world)
    a = camera_args(Camera(0.0, 0.0, -4.0, width=W, height=H))
    args = (torch.as_tensor(a["view"]), torch.as_tensor(a["vp"]), a["focal_x"],
            a["focal_y"], a["tan_fovx"], a["tan_fovy"])
    target = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (H, W, 3)),
                             dtype=torch.float32)
    return params, args, target


def main() -> None:
    outdir = sys.argv[1]
    torch.set_num_threads(1)
    multihost.initialize(backend="gloo", timeout_s=60.0)
    rank, world = multihost.process_index(), multihost.process_count()
    mesh = multihost.global_mesh("cpu")
    params, args, target = scene(world)
    m = params["means"].shape[0] // world
    local = multihost.host_local_params(
        {k: v[rank * m:(rank + 1) * m].numpy() for k, v in params.items()}, mesh)

    with torch.no_grad():
        img, stats = fs.render_fast_sharded(local, *args, W, H, CFG, mesh,
                                            exch_factor=float(world))
    assert int(stats["overflow"]) == 0, stats

    raw = {k: v.detach().requires_grad_(True)
           for k, v in raw_from_params(local[0]).items()}
    img_g, _ = fs.render_fast_sharded([params_from_raw(raw)], *args, W, H, CFG, mesh,
                                      exch_factor=float(world))
    loss = losses.gs_loss(img_g[..., :3], target, 0.2)
    grads = dict(zip(raw, torch.autograd.grad(loss, list(raw.values()))))
    np.savez(os.path.join(outdir, f"grads{rank}.npz"),
             **{k: g.numpy() for k, g in grads.items()})

    optimizer = make_optimizer(TrainConfig(lambda_dssim=0.2))
    raw0 = [raw_from_params(local[0])]
    new_raw, _, step_loss, st = fs.train_step_fast_sharded(
        raw0, [optimizer.init(raw0[0])], target, *args, width=W, height=H, cfg=CFG,
        mesh=mesh, optimizer=optimizer, exch_factor=float(world))
    assert int(st["overflow"]) == 0
    assert all(bool(torch.isfinite(v).all()) for v in new_raw[0].values())
    if rank == 0:
        np.save(os.path.join(outdir, "img.npy"), img.numpy())
        np.save(os.path.join(outdir, "loss.npy"),
                np.asarray([float(loss.detach()), float(step_loss)], np.float64))
    multihost.shutdown()
    with open(os.path.join(outdir, f"ok{rank}"), "w") as fh:
        fh.write(f"{mesh!r} exchanged {int(stats['exchanged_records'])}\n")


if __name__ == "__main__":
    main()
