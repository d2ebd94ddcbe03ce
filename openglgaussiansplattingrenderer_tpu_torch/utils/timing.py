"""Frame and stage timing.

Counterpart of ``openglgaussiansplattingrenderer_tpu/utils/timing.py``,
the replacement of the reference's GL timer queries: the per-frame
``GL_TIMESTAMP`` pair printed each loop (``main.cpp:53-54,84-88``) and the
stage wall clocks of cpuRender (``Splats.cpp:777-781,847,956,1135``).

CUDA work is queued: a host clock read right after a call measures the
launch, not the work. Every timer here fences first: ``fence`` waits for
each CUDA device that a tensor of the result lies on; CPU tensors are
already computed.

``span`` marks the port's stages from inside: while a ``torch.profiler``
records, each ``gs.*`` span is a ``record_function`` range on the same
clock as the kernels, copies and memsets of that profiler's trace; while
none records, it costs one flag read and records nothing.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.autograd import profiler as _profiler


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def fence(x) -> None:
    """Wait until the tensors in ``x`` (a tensor, or dicts, lists and
    tuples of them) are computed: ``torch.cuda.synchronize`` once for each
    CUDA device among them; nothing for CPU tensors."""
    devices = {t.device for t in _tensors(x) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks one stage of a frame or a step as the
    range ``name`` (``gs.<stage>``): ``torch.profiler.record_function(name)``
    while a profiler records, else one shared no-op that allocates and
    records nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class FrameTimer:
    """Per-frame ms timer, the analogue of the reference's
    ``glQueryCounter(GL_TIMESTAMP)`` pair (``main.cpp:53-54,84-88``)."""

    def __init__(self):
        self.frames_ms: List[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            fence(result)
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.frames_ms.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.frames_ms:
            return {"frames": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "fps": 0.0}
        a = np.asarray(self.frames_ms[1:] or self.frames_ms)  # drop warmup
        return {
            "frames": len(self.frames_ms),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "fps": float(1000.0 / max(a.mean(), 1e-9)),
        }


def require_device(device: str) -> torch.device:
    """``torch.device(device)``; exits with "no CUDA device" where a CUDA
    device is asked for and none is there (a script run on the card never
    carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("FATAL: no CUDA device (pass --device cpu to run on the CPU)")
    return dev


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return lines[dev.index or 0].strip()


def median_ms(fn: Callable, device, iters: int = 20, repeats: int = 3):
    """(median over ``repeats`` of the mean ms of ``iters`` calls of ``fn``,
    the last result), after one warm-up call: CUDA events around the calls
    on a card, the host clock on the CPU."""
    out = fn()
    fence(out)
    times = []
    for _ in range(repeats):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            times.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(times), out
