"""The port's process-group backend (``parallel/multihost.py``) on the CPU:
two gloo ranks on a free localhost port, launched by ``multihost.spawn``
(``tests/_torch_multihost_worker.py``), against the single-controller mesh
of two CPU shards in this process.

Held: the two ranks' frame bit-equal to ``render_fast_sharded`` on
``["cpu"] * 2`` (the all-to-all and the gathers concatenate in rank order,
the controller's shard order); the gradients of the 3DGS loss with
respect to each rank's rows within 1e-6 of each tensor's largest of the
single-controller gradients (the all-reduce of gloo may add the ranks'
terms in another order than the controller's sum: two terms commute, more
need not); the train step's loss equal to the gradient run's; a rank that
outlives its limit killed with every other; ``initialize`` a no-op without
the launcher's environment.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from openglgaussiansplattingrenderer_tpu_torch.parallel import fast_sharded as fs
from openglgaussiansplattingrenderer_tpu_torch.parallel import multihost
from openglgaussiansplattingrenderer_tpu_torch.parallel import sharded as sh
from openglgaussiansplattingrenderer_tpu_torch.train import losses
from openglgaussiansplattingrenderer_tpu_torch.train.trainer import (
    params_from_raw,
    raw_from_params,
)
from _torch_threads import one_torch_thread  # noqa: F401, E402
import _torch_multihost_worker as worker  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_multihost_worker.py")
RANK_TIMEOUT_S = 240.0
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _env():
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_gloo_ranks_match_the_single_controller_mesh(tmp_path):
    results = multihost.spawn([sys.executable, WORKER, str(tmp_path)], 2,
                              timeout_s=RANK_TIMEOUT_S, env=_env())
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out}"
        assert (tmp_path / f"ok{rank}").exists()
    assert "ProcessMesh(rank 1 of 2, cpu, gloo)" in (tmp_path / "ok1").read_text()

    params, args, target = worker.scene(2)
    mesh = sh.make_mesh(devices=["cpu"] * 2)
    with torch.no_grad():
        img, stats = fs.render_fast_sharded(params, *args, worker.W, worker.H, worker.CFG,
                                            mesh, exch_factor=2.0)
    np.testing.assert_array_equal(np.load(tmp_path / "img.npy"), img.numpy())
    assert f"exchanged {int(stats['exchanged_records'])}" in (tmp_path / "ok0").read_text()

    raw = {k: v.detach().requires_grad_(True) for k, v in raw_from_params(params).items()}
    img_g, _ = fs.render_fast_sharded(params_from_raw(raw), *args, worker.W, worker.H,
                                      worker.CFG, mesh, exch_factor=2.0)
    loss = losses.gs_loss(img_g[..., :3], target, 0.2)
    grads = dict(zip(raw, torch.autograd.grad(loss, list(raw.values()))))
    m = params["means"].shape[0] // 2
    for rank in range(2):
        got = np.load(tmp_path / f"grads{rank}.npz")
        for k, g in grads.items():
            want = g[rank * m:(rank + 1) * m].numpy()
            scale = float(np.abs(g.numpy()).max())
            assert np.abs(got[k] - want).max() <= 1e-6 * scale, (rank, k)
    loss_mh, step_loss = np.load(tmp_path / "loss.npy")
    assert abs(loss_mh - float(loss.detach())) <= 1e-6
    assert step_loss == loss_mh


def test_spawn_kills_a_rank_that_outlives_its_limit():
    """A rank that never ends is killed, with every other rank, and the
    launcher raises with what each printed."""
    argv = [sys.executable, "-c",
            "import os, time; print('rank', os.environ['RANK'], flush=True); "
            "time.sleep(0 if os.environ['RANK'] == '0' else 600)"]
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="killed") as info:
        multihost.spawn(argv, 2, timeout_s=5.0, env=_env())
    assert time.monotonic() - t0 < 60.0
    assert "rank 1" in str(info.value)


def test_spawn_passes_the_launcher_environment():
    argv = [sys.executable, "-c",
            "import os; print(*(os.environ[k] for k in "
            "('MASTER_ADDR', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK')))"]
    results = multihost.spawn(argv, 3, timeout_s=60.0, env=_env())
    assert [out.split() for _, out in results] == [["localhost", "3", str(r), str(r)]
                                                   for r in range(3)]
    assert all(rc == 0 for rc, _ in results)


def test_initialize_is_a_noop_without_the_launcher_environment(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.global_mesh("cpu")
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("localhost:1", num_processes=2)
    # a single-process mesh holds the whole scene: host_local_params splits it
    mesh = sh.make_mesh(devices=["cpu"] * 2)
    rows = {"means": np.arange(12, dtype=np.float32).reshape(4, 3)}
    shards = multihost.host_local_params(rows, mesh)
    assert [s["means"].shape[0] for s in shards] == [2, 2]
    assert torch.equal(shards[1]["means"], torch.from_numpy(rows["means"][2:]))
