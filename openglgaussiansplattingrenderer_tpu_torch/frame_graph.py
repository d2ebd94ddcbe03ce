"""A frame that needs no gradient, replayed as one captured CUDA graph.

An eager frame costs its host time: each stage's wrapper, each launch, the
Python between them; the device idles while the host builds it. Once
``capacity_records`` is pinned a frame has fixed shapes, every kernel takes
its arguments by value on the current stream, and nothing in it waits for
the device, so it can be captured once and replayed: one graph launch
between the pose and the frame's last kernel.

``FrameGraphs.render`` is ``fastpath.render_fast`` with that policy:

- it engages on one CUDA device, where no input requires a gradient (or
  grad mode is off), and not inside another capture;
- the key is every parameter tensor's address, shape, stride and dtype, the
  device, the frame's scalars (``width``, ``height``, the focals and the
  tangents, which the kernels take by value) and the ``RenderConfig``;
- a key captures only when it arrives twice in a row, so a one-off frame, or
  a caller that brings new tensors every call, never pays for a capture;
  one graph is kept a device, and a capture drops the one before;
- the capture: a warm-up run on a side stream, then the capture there. The
  camera matrices are the graph's static input: host matrices are written
  into a pinned buffer that the graph copies in as its first node
  (``utils.device.Staging``), matrices on the device are copied in before
  the replay;
- a replay returns fresh tensors: the image copied once; the stats, packed
  inside the graph into one small byte buffer, copied once and split into
  views. The two stay apart, since a caller may keep every frame's stats
  and let the images go;
- a capture that fails is counted, leaves its key on the eager path, and
  never raises into the caller;
- a second thread that renders while a replay is being queued takes the
  eager path; a replay queued on another stream than the last waits (on
  the device) until the last one's outputs were copied.

Counters, on the ``counter`` object (``render.render_arrays``):
``captures``, ``replays``, ``eager`` (frames that did not replay) and
``capture_failures``; ``replays / (replays + eager)`` is the share of frames
the graph served. The kernel wrappers' ``.launches`` counters count what
ran: a replay adds what its capture recorded, the capture itself adds
nothing, and the warm-up adds what it launched.
"""

from __future__ import annotations

import importlib
import math
import threading
import traceback
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from openglgaussiansplattingrenderer_tpu_torch.ops.kernels import build
from openglgaussiansplattingrenderer_tpu_torch.utils import device as device_

# the modules whose wrappers carry a ``.launches`` counter
_KERNEL_MODULES = ("adam", "composite", "radix_sort", "record_sort", "records", "scan",
                   "ssim_loss", "table")


def launch_counters() -> list:
    """Every kernel wrapper of ``ops.kernels`` with a ``.launches`` counter."""
    found = []
    for name in _KERNEL_MODULES:
        mod = importlib.import_module(
            f"openglgaussiansplattingrenderer_tpu_torch.ops.kernels.{name}")
        for v in vars(mod).values():
            if callable(v) and hasattr(v, "launches") and all(v is not f for f in found):
                found.append(v)
    return found


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class Run(NamedTuple):
    """Stats of one item size, side by side in the packed byte buffer."""
    itemsize: int
    offset: int                     # bytes
    nbytes: int
    names: Tuple[str, ...]
    dtypes: Tuple[torch.dtype, ...]
    shapes: Tuple[Tuple[int, ...], ...]


def pack(stats: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, tuple]:
    """The stats as one uint8 tensor, a run for each item size (widest
    first, so each run lies at an offset its items can be viewed at), and
    the layout ``unpack`` takes."""
    sizes: Dict[int, list] = {}
    for k, t in stats.items():
        sizes.setdefault(t.element_size(), []).append(k)
    parts, at, runs = [], 0, []
    for size in sorted(sizes, reverse=True):
        names = tuple(sizes[size])
        ts = [stats[k].detach() for k in names]
        nbytes = sum(t.numel() for t in ts) * size
        runs.append(Run(size, at, nbytes, names, tuple(t.dtype for t in ts),
                        tuple(tuple(t.shape) for t in ts)))
        parts += [t.reshape(-1).view(torch.uint8) for t in ts]
        at += nbytes
    return torch.cat(parts), (tuple(stats), runs)


def unpack(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """The stats of a packed buffer, in the order they were packed: views
    of ``flat``. A run of 0-d stats costs one view and one unbind, and a
    view more for each stat of another dtype than the run's integers."""
    order, runs = layout
    out = {}
    for r in runs:
        ints = _INT_OF_SIZE[r.itemsize]
        run = (flat if r.nbytes == flat.numel() else
               flat[r.offset:r.offset + r.nbytes]).view(ints)
        if all(not s for s in r.shapes):
            items = run.unbind(0)
        else:
            items, at = [], 0
            for shape in r.shapes:
                n = math.prod(shape)
                items.append(run[at:at + n].view(shape))
                at += n
        for name, dtype, t in zip(r.names, r.dtypes, items):
            out[name] = t if dtype == ints else t.view(dtype)
    return {k: out[k] for k in order}


class _Replay:
    """A captured graph of one device, replayed on the caller's stream."""

    def __init__(self, graph, device):
        self.graph, self.device = graph, device
        self.stream = None

    def begin(self) -> None:
        """Order what the current stream does next after the last replay and
        the copy of its output, where those ran on another stream (a wait
        of the device, not of the host)."""
        stream = build.stream_ptr()
        if self.stream is not None and stream != self.stream:
            done = torch.cuda.Event()
            done.record(torch.cuda.ExternalStream(self.stream, device=self.device))
            torch.cuda.current_stream(self.device).wait_event(done)
        self.stream = stream

    def replay(self) -> None:
        self.graph.replay()


class CudaGraphs:
    """What ``FrameGraphs`` asks of the card: torch's CUDA graphs, captured
    on a side stream of the device's own."""

    def __init__(self):
        self._streams = {}

    def usable(self, device: torch.device) -> bool:
        return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()

    def _stream(self, device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def warm_up(self, fn, device) -> None:
        """Run ``fn`` once on the side stream, after what the current stream
        has queued, and make the current stream wait for it."""
        side, cur = self._stream(device), torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()
        cur.wait_stream(side)

    def capture(self, fn, device):
        """Capture ``fn`` on the side stream; returns (the replay handle,
        what ``fn`` returned: the graph's static outputs)."""
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream(device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        return _Replay(graph, device), out


class _Frame(NamedTuple):
    """One device's captured frame."""
    key: tuple
    handle: object
    staging: Optional[device_.Staging]   # host matrices: the graph copies them in
    mats: torch.Tensor          # (2, 4, 4): view, vp, the static input
    image: torch.Tensor         # the static outputs: the image, the packed stats
    packed: torch.Tensor
    layout: tuple
    deltas: list                # (wrapper, launches a replay)


def frame_key(params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy, width, height,
              cfg) -> Optional[tuple]:
    """The graph's key of a frame, or None where the graph does not apply
    (an input that needs a gradient, tensors off the frame's device, not
    4x4 matrices). Whether the matrices come from the host is part of it:
    a graph copies host matrices in itself."""
    device = params["means"].device
    grad = torch.is_grad_enabled()
    items = []
    for name in sorted(params):
        t = params[name]
        if not torch.is_tensor(t) or t.device != device or (grad and t.requires_grad):
            return None
        items.append((name, t.data_ptr(), t.shape, t.stride(), t.dtype))
    for m in (view, vp):
        if tuple(m.shape if torch.is_tensor(m) else getattr(m, "shape", ())) != (4, 4):
            return None
        if torch.is_tensor(m) and grad and m.requires_grad:
            return None
    host = device_.is_host_matrix(view) and device_.is_host_matrix(vp)
    return (device, tuple(items), float(focal_x), float(focal_y), float(tan_fovx),
            float(tan_fovy), int(width), int(height), cfg, host)


class FrameGraphs:
    """``fastpath.render_fast`` behind one captured graph a device (module
    docstring). ``backend`` captures and replays (``CudaGraphs`` by default);
    ``counter`` gets the frame counts as attributes."""

    def __init__(self, counter, backend=None):
        self.counter = counter
        self.backend = backend if backend is not None else CudaGraphs()
        self.last_error: Optional[str] = None
        self._lock = threading.Lock()
        self._last = {}         # device -> the latest frame's key
        self._frames = {}       # device -> _Frame
        self._failed = set()    # keys whose capture failed

    def clear(self) -> None:
        """Drop every graph and what was seen: the next frames run eagerly
        until a key repeats. For callers that swap the frame's code."""
        with self._lock:
            self._frames.clear()
            self._last.clear()
            self._failed.clear()

    def render(self, params, view, vp, focal_x, focal_y, tan_fovx, tan_fovy,
               width: int, height: int, cfg):
        """One frame: ((H, W, 4) image, stats), as ``render_fast`` returns
        them, from the device's graph where the policy allows."""
        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath

        device = params["means"].device
        frame = (focal_x, focal_y, tan_fovx, tan_fovy, width, height, cfg)
        key = (frame_key(params, view, vp, *frame) if self.backend.usable(device)
               else None)
        if key is not None and self._lock.acquire(blocking=False):
            try:
                out = self._graphed(key, device, params, view, vp, frame)
            finally:
                self._lock.release()
            if out is not None:
                return out
        self.counter.eager += 1
        return fastpath.render_fast(params, *device_.matrices(view, vp, device), *frame)

    def _graphed(self, key, device, params, view, vp, frame):
        entry = self._frames.get(device)
        last, self._last[device] = self._last.get(device), key
        if entry is None or entry.key != key:
            if last != key or key in self._failed:
                return None
            self._frames.pop(device, None)       # one graph a device
            entry = self._capture(key, device, params, view, vp, frame)
            if entry is None:
                return None
            self._frames[device] = entry
        return self._replay(entry, view, vp)

    def _capture(self, key, device, params, view, vp, frame) -> Optional[_Frame]:
        from openglgaussiansplattingrenderer_tpu_torch.ops import fastpath

        mats = torch.empty((2, 4, 4), dtype=torch.float32, device=device)
        staging = device_.Staging(device) if key[-1] else None    # host matrices
        if staging is None:
            device_.matrices(view, vp, device, out=mats)
        else:
            staging.write(view, vp)
        layout = []

        def run():
            if staging is not None:         # the graph's first node: the matrices
                staging.upload(mats)
            image, stats = fastpath.render_fast(params, mats[0], mats[1], *frame)
            packed, got = pack(stats)
            layout[:] = [got]
            return image, packed

        self.backend.warm_up(run, device)      # a real frame: its launches count
        counters = launch_counters()
        before = [c.launches for c in counters]
        try:
            handle, (image, packed) = self.backend.capture(run, device)
        except Exception:      # the frame goes on eagerly; the key stays there
            self.last_error = traceback.format_exc()
            warnings.warn(f"frame graph capture failed, frames of this key run eagerly:\n"
                          f"{self.last_error}", RuntimeWarning, stacklevel=4)
            self._failed.add(key)
            self.counter.capture_failures += 1
            return None
        finally:
            deltas = [(c, c.launches - b) for c, b in zip(counters, before)
                      if c.launches != b]
            for c, b in zip(counters, before):
                c.launches = b             # a capture launches nothing
        self.counter.captures += 1
        return _Frame(key, handle, staging, mats, image, packed, layout[0], deltas)

    def _replay(self, entry: _Frame, view, vp):
        entry.handle.begin()
        if entry.staging is not None:
            entry.staging.write(view, vp)
        else:
            device_.matrices(view, vp, entry.mats.device, out=entry.mats)
        entry.handle.replay()
        # fresh tensors: callers keep frames, and the stats of many frames
        image, flat = entry.image.clone(), entry.packed.clone()
        for c, d in entry.deltas:
            c.launches += d
        self.counter.replays += 1
        return image, unpack(flat, entry.layout)
