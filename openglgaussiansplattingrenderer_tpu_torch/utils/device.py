"""Values a frame takes from the host, put on its device without waiting.

A ``torch.tensor(<host values>, device=...)`` copy from pageable memory
waits for the device's stream, so a frame that makes one inside itself
waits for every kernel queued before it. Here:

- ``constant`` and ``arange``: read-only device tensors made once per
  (device, dtype, values) and then shared (the background colour, the tile
  ids); the first call makes them, a graph capture never does;
- ``matrices``: a camera's two 4x4 matrices. Host matrices (numpy arrays,
  CPU tensors) go through a ring of pinned buffers by one non-blocking copy
  of both; an event per buffer keeps it from being written again before its
  copy has run. Matrices already on the device pass as ``torch.as_tensor``
  passes them;
- ``Staging``: the same for a captured frame, whose graph holds the copy.

Every value equals, bit for bit, what ``torch.tensor`` or
``torch.as_tensor`` with ``dtype=torch.float32`` gives.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

_constants = {}        # (tag, device, dtype, values) -> tensor


def _cached(key, make) -> torch.Tensor:
    t = _constants.get(key)
    if t is None:
        device = key[1]
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # a tensor made inside a capture holds nothing until a replay
            raise RuntimeError(f"device constant {key!r} first asked for inside a "
                               "CUDA graph capture")
        t = _constants.setdefault(key, make())
    return t


def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` of a flat
    sequence of numbers, made once and shared: callers must not write to
    it."""
    values = tuple(values)
    return _cached(("constant", torch.device(device), dtype, values),
                   lambda: torch.tensor(values, dtype=dtype, device=device))


def arange(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.arange(n, dtype=dtype, device=device)``, made once and
    shared: callers must not write to it."""
    return _cached(("arange", torch.device(device), dtype, int(n)),
                   lambda: torch.arange(int(n), dtype=dtype, device=device))


def is_host_matrix(m) -> bool:
    """A 4x4 matrix on the host: a numpy array (or anything numpy reads as
    one) or a CPU tensor that needs no gradient."""
    if torch.is_tensor(m):
        return m.device.type == "cpu" and not m.requires_grad and tuple(m.shape) == (4, 4)
    return np.shape(m) == (4, 4)


def fill_host(arr: np.ndarray, view, vp) -> None:
    """Write host matrices ``view`` and ``vp`` into ``arr``, a (2, 4, 4)
    float32 array, rounded as ``torch.as_tensor(m, dtype=float32)`` rounds
    them (numpy's cast and torch's are both C's, round to nearest even)."""
    for i, m in enumerate((view, vp)):
        if torch.is_tensor(m):
            torch.from_numpy(arr[i]).copy_(m)
        else:
            np.copyto(arr[i], np.asarray(m), casting="unsafe")


class _Ring:
    """Pinned (2, 4, 4) buffers of one device, taken in turn."""

    SLOTS = 8

    def __init__(self):
        self.lock = threading.Lock()
        self.bufs = [torch.empty((2, 4, 4), dtype=torch.float32, pin_memory=True)
                     for _ in range(self.SLOTS)]
        self.arrays = [b.numpy() for b in self.bufs]
        self.events = [None] * self.SLOTS
        self.next = 0

    def copy(self, view, vp, dst: torch.Tensor) -> None:
        """Stage both matrices and copy them into ``dst`` on the current
        stream, without waiting for it."""
        with self.lock:
            i = self.next
            self.next = (i + 1) % self.SLOTS
            if self.events[i] is None:
                self.events[i] = torch.cuda.Event()
            else:      # the copy out of this buffer, SLOTS frames ago
                self.events[i].synchronize()
            fill_host(self.arrays[i], view, vp)
            dst.copy_(self.bufs[i], non_blocking=True)
            self.events[i].record(torch.cuda.current_stream(dst.device))


class Staging:
    """The host matrices of a captured frame: one (2, 4, 4) float32 buffer,
    pinned on a card, that the graph copies to the device as its first
    node (``upload``, called while capturing); an event recorded after the
    copy keeps ``write`` from changing the buffer before the last replay's
    copy has run."""

    def __init__(self, device: torch.device):
        cuda = torch.device(device).type == "cuda"
        self.buf = torch.empty((2, 4, 4), dtype=torch.float32, pin_memory=cuda)
        self.arr = self.buf.numpy()
        self.copied = torch.cuda.Event(external=True) if cuda else None

    def write(self, view, vp) -> None:
        if self.copied is not None:
            self.copied.synchronize()      # returns at once unless a frame is queued
        fill_host(self.arr, view, vp)

    def upload(self, dst: torch.Tensor) -> None:
        dst.copy_(self.buf, non_blocking=True)
        if self.copied is not None:
            self.copied.record()


_rings = {}            # device -> _Ring
_rings_lock = threading.Lock()


def _ring(device: torch.device) -> _Ring:
    ring = _rings.get(device)
    if ring is None:
        with _rings_lock:
            ring = _rings.setdefault(device, _Ring())
    return ring


def matrices(view, vp, device: torch.device, out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``view`` and ``vp`` as float32 tensors on ``device``, as
    ``torch.as_tensor(m, dtype=torch.float32, device=device)`` gives them,
    with no wait for the device's stream. With ``out``, a (2, 4, 4) float32
    tensor on ``device``, they are written into ``out[0]`` and ``out[1]``,
    which are returned."""
    device = torch.device(device)
    if device.type == "cuda" and is_host_matrix(view) and is_host_matrix(vp):
        dst = out if out is not None else torch.empty((2, 4, 4), dtype=torch.float32,
                                                      device=device)
        _ring(device).copy(view, vp, dst)
        return dst[0], dst[1]
    view, vp = (torch.as_tensor(m, dtype=torch.float32, device=device) for m in (view, vp))
    if out is None:
        return view, vp
    out[0].copy_(view)
    out[1].copy_(vp)
    return out[0], out[1]
