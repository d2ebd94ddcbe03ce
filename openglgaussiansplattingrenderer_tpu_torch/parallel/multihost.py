"""Multi-process runs of the sharded renderer on a ``torch.distributed``
process group.

Counterpart of ``openglgaussiansplattingrenderer_tpu/parallel/multihost.py``.
The JAX module wires ``jax.distributed.initialize``, builds a mesh over
every process's devices and makes global arrays from host-local shards.
Here ``initialize`` joins a process group (NCCL for CUDA, gloo for the
CPU), and ``global_mesh`` returns a ``ProcessMesh``: one splat shard a
rank, on ``cuda:LOCAL_RANK`` unless told otherwise, with the four
collectives of ``parallel.sharded.Mesh`` (``all_gather``, ``all_to_all``,
``psum``, ``pmean``) and its ``gather`` run through ``torch.distributed``.
``fast_sharded``'s stages loop over ``mesh.local``, which is this rank's
shard alone, so the same code renders a frame and backpropagates through
it across processes. The tiled all-gather and the all-to-all concatenate
in rank order, the single-controller mesh's shard order, so a frame is
bit-equal to the single-controller frame on the same splat shards.

Autograd: each collective is a ``torch.autograd.Function``. ``all_to_all``
transposes to the reverse all-to-all and ``all_gather`` to a
reduce-scatter (each rank consumes the gathered tensor in its own way, as
each shard does under one controller). ``psum`` and ``gather`` produce what
every rank then computes whole and alike (a loss, an assembled image), as
a single controller computes it once: their backward takes the rank's own
share of that one cotangent (the cotangent itself for ``psum``, the rank's
rows for ``gather``), where summing over ranks would count it once a rank.

gloo takes CPU tensors only for ``all_to_all``. Under gloo, CUDA tensors
are staged through the host explicitly for every collective: the mesh
says so once on stderr and keeps the seconds spent copying in
``mesh.staging_s``. NCCL refuses two ranks on one device, so two ranks on
one card run gloo.

``spawn`` launches a command as the ranks of one group on this host, as
torchrun does (``MASTER_ADDR``, ``MASTER_PORT`` on a free localhost port,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), and kills every rank when one
outlives its time limit.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import Params

DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (a no-op for a single-process run).

    Arguments default to the launcher's environment, as torchrun sets it:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``. Without a
    coordinator and a process count (or with one process) nothing happens,
    as in the JAX package. ``backend`` defaults to NCCL where CUDA is
    present, else gloo; ``timeout_s`` bounds every collective's wait."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        raise ValueError("initialize: a multi-process run needs its process_id (RANK)")
    if dist.is_initialized():
        raise RuntimeError("initialize: this process already joined a process group")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", process_index()))


class ProcessMesh:
    """One mesh axis over the ranks of the process group, one shard a rank:
    rank d runs shard d on ``device``. ``local`` is [(rank, device)], so
    a stage loop runs this rank's shard; collectives take and return one
    tensor (in a list) and run through ``torch.distributed``."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh: call multihost.initialize(...) first")
        self.device = torch.device(device)
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.staging_s = 0.0
        if self.staged:
            print(f"ProcessMesh rank {self.rank}: gloo backend with {self.device}: "
                  "every collective stages its CUDA tensors through the host",
                  file=sys.stderr, flush=True)

    @property
    def local(self):
        return [(self.rank, self.device)]

    @property
    def out_device(self) -> torch.device:
        return self.device

    def __repr__(self) -> str:
        return f"ProcessMesh(rank {self.rank} of {self.size}, {self.device}, {self.backend})"

    def local_shards(self, params) -> List[Params]:
        """This rank's shard: a global dict's row block ``rank`` of ``size``
        (its row count divisible by the world size), or a one-dict list
        taken as it is (``host_local_params``)."""
        if isinstance(params, dict):
            n = params["means"].shape[0]
            if n % self.size:
                raise ValueError(f"{n} splats not divisible by {self.size} ranks; use "
                                 "pad_scene_for_mesh")
            m = n // self.size
            return [{k: v[self.rank * m:(self.rank + 1) * m].to(self.device)
                     for k, v in params.items()}]
        if len(params) != 1:
            raise ValueError(f"{len(params)} parameter shards for one rank")
        return list(params)

    # ---- host staging under gloo -------------------------------------------
    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor to hand the backend: on the host where gloo must have it."""
        if not self.staged:
            return x.contiguous()
        t0 = time.perf_counter()
        y = x.detach().cpu()
        self.staging_s += time.perf_counter() - t0
        return y

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return x
        t0 = time.perf_counter()
        y = x.to(self.device)
        torch.cuda.synchronize(self.device)
        self.staging_s += time.perf_counter() - t0
        return y

    def _empty(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(shape, dtype=like.dtype,
                           device="cpu" if self.staged else like.device)

    # ---- the raw collectives (no autograd) ---------------------------------
    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        xo = self._out(x)
        parts = [self._empty(xo.shape, xo) for _ in range(self.size)]
        dist.all_gather(parts, xo)
        return self._back(torch.cat(parts))

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all: axis 0 of {tuple(x.shape)} does not split "
                             f"into {self.size} blocks")
        xo = self._out(x)
        out = self._empty(xo.shape, xo)
        dist.all_to_all_single(out, xo)
        return self._back(out)

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        xo = self._out(x)
        xo = xo.clone() if xo is x else xo
        dist.all_reduce(xo)
        return self._back(xo)

    # ---- the mesh's collectives ------------------------------------------
    def all_gather(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = xs
        return [_AllGather.apply(self, x)]

    def all_to_all(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = xs
        return [_AllToAll.apply(self, x)]

    def psum(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = xs
        return [_Psum.apply(self, x)]

    def pmean(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [t / self.size for t in self.psum(xs)]

    def gather(self, xs: List[torch.Tensor]) -> torch.Tensor:
        (x,) = xs
        return _Gather.apply(self, x)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all; its transpose is the same exchange of the
    cotangent's blocks."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh._all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._all_to_all(g)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather; its transpose is a reduce-scatter (an all-reduce
    of the cotangent, then this rank's rows)."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return mesh._all_gather(x)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.rank
        return None, ctx.mesh._all_reduce(g)[r * ctx.rows:(r + 1) * ctx.rows]


class _Psum(torch.autograd.Function):
    """Sum over ranks; what follows it runs alike on every rank, so the
    backward hands each rank the one cotangent."""

    @staticmethod
    def forward(ctx, mesh, x):
        return mesh._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Gather(torch.autograd.Function):
    """The concatenation of every rank's tensor, in rank order, on every
    rank; what follows it runs alike on every rank, so the backward takes
    this rank's rows of the one cotangent."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.rank, ctx.rows = mesh.rank, x.shape[0]
        return mesh._all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def global_mesh(device=None) -> ProcessMesh:
    """The process mesh over every rank of the group, this rank's shard on
    ``device`` (default ``cuda:LOCAL_RANK``; pass ``"cpu"`` for CPU ranks,
    or one card's name for several ranks on that card under gloo)."""
    if device is None:
        device = torch.device("cuda", local_rank())
    return ProcessMesh(device)


def host_local_params(params: Dict[str, np.ndarray], mesh) -> List[Params]:
    """The parameter shards this process holds, from its own slice of the
    scene (``1 / process_count`` of the rows, already padded so the global
    count divides the mesh): on a ``ProcessMesh`` one dict on this rank's
    device; on a single-process mesh (``sharded.Mesh``) the scene is whole
    and is split by ``shard_params``."""
    from openglgaussiansplattingrenderer_tpu_torch.parallel.sharded import shard_params

    tensors = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
               for k, v in params.items()}
    if not isinstance(mesh, ProcessMesh):
        return shard_params(tensors, mesh)
    return [{k: v.to(mesh.device) for k, v in tensors.items()}]


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv: List[str], nprocs: int, *, timeout_s: float, env=None,
          cwd=None) -> List[tuple]:
    """Run ``argv`` as ``nprocs`` ranks of one process group on this host,
    each with torchrun's environment on a free localhost port. Returns
    [(exit code, output)] in rank order. When the ranks have not all
    ended ``timeout_s`` seconds after the start, every rank is killed and
    ``TimeoutError`` raised with what each printed. Output goes to
    temporary files, so a rank that prints much never blocks on a pipe."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    logs = [tempfile.TemporaryFile() for _ in range(nprocs)]
    procs = []
    try:
        for r, log in enumerate(logs):
            e = dict(base, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     WORLD_SIZE=str(nprocs), RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen(argv, env=e, cwd=cwd, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        timed_out = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read().decode(errors="replace"))
        log.close()
    if timed_out:
        raise TimeoutError(f"{nprocs} ranks of {argv} not done after {timeout_s} s; "
                           "killed:\n" + "\n".join(
                               f"--- rank {r}:\n{o[-4000:]}" for r, o in enumerate(outs)))
    return [(p.returncode, o) for p, o in zip(procs, outs)]
