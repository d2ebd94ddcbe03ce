"""The traced window: torch.profiler's timeline reduced to what the
per-layer readers take.

``Records`` holds the device seconds of each kernel by the profiler's
name, the traced window's length and the device's busy time in it (the
union of every kernel, copy and memset interval), the shapes of each
traced frame or step, the host's seconds for each untraced call (the
enqueue cost, before any synchronisation), the program's ``gs.*`` spans in
the window (``spans.reduce_spans``) and the change in each of the
program's counters over the traced units (``sut.counters``; empty where
the program keeps none). ``breakdown`` gives the
device operations that took most time and the longest idle gaps by what
the host was doing: the innermost host event (operator, annotation or
runtime call) that covers the middle of the gap.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclasses.dataclass
class Records:
    kernels: Dict[str, float]
    window_s: float
    busy_s: float
    units: List[dict]
    host_s: List[float]
    power: str = ""
    device_ops: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: List[dict], top: int = 10) -> dict:
    """Chrome-trace events -> kernel seconds by name, window, busy time,
    top device operations and idle gaps by host activity. The window is
    the ``bench.window`` annotation; device events are clipped to it."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("trace: no bench.window annotation in the profiler's events")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    kernels: Dict[str, float] = defaultdict(float)
    ops: Dict[str, float] = defaultdict(float)
    dev: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            ops[e["name"]] += (b - a) * 1e-6
            if cat == "kernel":
                kernels[e["name"]] += (b - a) * 1e-6
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((a, b, e["name"]))
    busy = _union(dev)
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    nxt, active = 0, []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        cover = [(hb - ha, name) for ha, hb, name in active]
        gaps[min(cover)[1] if cover else "host: between operators"] += (b - a) * 1e-6
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"kernels": dict(kernels), "window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": rank(ops), "idle_gaps": rank(gaps)}


def read_profile(prof) -> dict:
    """``reduce_events`` of a finished ``torch.profiler.profile``, and its
    ``spans.reduce_spans`` under ``spans``; the timeline goes through a
    chrome trace in a temporary directory, which is removed."""
    from benchmark import spans

    with tempfile.TemporaryDirectory(prefix="bench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return dict(reduce_events(events), spans=spans.reduce_spans(events))
