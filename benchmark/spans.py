"""The program's own ``gs.*`` spans in a traced window, put down to stages.

The port marks each stage of a frame or a training step with a
``gs.<stage>`` profiler range (``utils.timing.span``). While torch.profiler
records, each is a ``user_annotation`` event on the clock of the device's
kernels, copies and memsets. Every ``gs.*`` span but ``gs.frame`` and
``gs.step`` is a stage, read by its own name, so a span the port adds is
read with no edit here. ``reduce_spans`` reads the chrome-trace events of a
traced window (the ``bench.window`` annotation) and gives:

- for each stage: its host seconds; the kernel-launch calls
  (``cudaLaunchKernel*``, ``cuLaunchKernel*``) made inside it on its own
  thread; the device seconds of the kernels, memsets and copies that the
  CUDA API calls inside it launched, matched by ``args.correlation``; and the host seconds it waited in
  ``cuda*Synchronize`` calls;
- the root spans: each ``gs.step``, and each ``gs.frame`` outside a step;
  their count, their host seconds, the launch calls inside them on any
  thread, and the glue: the host seconds of each root that no stage span
  covers on any thread (the image assembly, the activation, the stats,
  the autograd engine), and the glue's waits in ``cuda*Synchronize`` by
  the outermost torch operator around each;
- ``idle_by_span``: each idle gap of the device by the innermost ``gs.*``
  span open at its middle on any thread, or "outside the program".

``values`` turns them into the per-layer numbers of a cell: a stage
group's host ms, the glue ms and the launches, each a mean over the root
spans, and the records layer's share of its roofline.

``run.py``'s traced runs (``--trace 1``) read them from ``Records.spans``
and print ``lines`` of them on standard error, beside the
``unattributed`` lines: one ``span:`` line a stage, the roots' line,
``glue_sync:`` and ``idle_by_span:`` lines and a ``spans:`` line with
``values`` as JSON.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from benchmark import roofline as rl
from benchmark import trace

FRAME, STEP = "gs.frame", "gs.step"
# the order in which the stages known today are listed; any other gs.* span
# is a stage too, listed after them by name
STAGES = ("gs.table", "gs.scan", "gs.expand", "gs.sort", "gs.composite", "gs.loss",
          "gs.loss.bwd", "gs.composite.bwd", "gs.sort.bwd", "gs.segsum", "gs.table.bwd",
          "gs.adam")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
CALL_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the program"

# each per-layer number: the stages whose host time it sums, by the root
GROUPS = {
    STEP: {"table_host_ms.train": ("gs.table", "gs.table.bwd"),
           "records_host_ms.train": ("gs.scan", "gs.expand", "gs.segsum"),
           "sort_host_ms.train": ("gs.sort", "gs.sort.bwd"),
           "composite_host_ms.train": ("gs.composite", "gs.composite.bwd"),
           "loss_host_ms.train": ("gs.loss", "gs.loss.bwd"),
           "adam_host_ms.train": ("gs.adam",)},
    FRAME: {"table_host_ms.render": ("gs.table",),
            "records_host_ms.render": ("gs.scan", "gs.expand"),
            "sort_host_ms.render": ("gs.sort",),
            "composite_host_ms.render": ("gs.composite",)},
}
SUFFIX = {STEP: "train", FRAME: "render"}


class _Disjoint:
    """Intervals that do not overlap (the stage spans of one thread, the
    root spans): which of them holds a time, by bisection."""

    def __init__(self, intervals):
        self.iv = sorted(intervals)
        self.starts = [iv[0] for iv in self.iv]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.iv[i] if i >= 0 and t <= self.iv[i][1] else None

    def covered(self, a: float, b: float) -> float:
        """The length of [a, b] that the intervals cover."""
        out = 0.0
        for x, y, *_ in self.iv[max(bisect.bisect_right(self.starts, a) - 1, 0):]:
            if x >= b:
                break
            out += max(0.0, min(b, y) - max(a, x))
        return out


def reduce_spans(events: List[dict]) -> dict:
    """Chrome-trace events -> the stages of the ``bench.window`` window, as
    the module's docstring says. Seconds throughout."""
    win = [e for e in events if e.get("name") == trace.WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("spans: no bench.window annotation in the profiler's events")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans, calls, by_corr, device, ops = [], [], {}, [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith("gs.") and w0 <= a and b <= w1:
            spans.append((a, b, name, e.get("tid")))
        elif cat in CALL_CATS and w0 <= a <= w1:
            calls.append((a, e.get("tid"), name, b))
            by_corr[(e.get("args") or {}).get("correlation")] = calls[-1]
        elif cat == "cpu_op" and w0 <= a <= w1:
            ops[e.get("tid")].append((a, b, name))
        elif cat in trace.DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b, (e.get("args") or {}).get("correlation"), cat))
    steps = _Disjoint([(a, b) for a, b, n, _ in spans if n == STEP])

    def in_step(a: float, b: float) -> bool:
        s = steps.at(a)
        return s is not None and b <= s[1]

    roots = [(a, b, n) for a, b, n, _ in spans
             if n == STEP or (n == FRAME and not in_step(a, b))]
    stage_spans = [s for s in spans if s[2] not in (FRAME, STEP)]
    by_thread = defaultdict(list)
    for a, b, n, tid in stage_spans:
        by_thread[tid].append((a, b, n))
    by_thread = {tid: _Disjoint(iv) for tid, iv in by_thread.items()}

    def stage_of(t: float, tid) -> Optional[str]:
        hit = by_thread[tid].at(t) if tid in by_thread else None
        return hit[2] if hit else None

    found = {s[2] for s in stage_spans}
    stages = {n: {"count": 0, "host_s": 0.0, "launches": 0, "device_s": 0.0, "sync_s": 0.0}
              for n in [n for n in STAGES if n in found] + sorted(found - set(STAGES))}
    for a, b, n, _ in stage_spans:
        stages[n]["count"] += 1
        stages[n]["host_s"] += (b - a) * 1e-6
    root_at = _Disjoint([(a, b) for a, b, _ in roots])
    for v in ops.values():
        v.sort()
    launches = in_roots = 0
    glue_sync: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for t, tid, name, end in calls:
        n = stage_of(t, tid)
        if name.startswith(LAUNCHES):
            launches += 1
            in_roots += root_at.at(t) is not None
            if n is not None:
                stages[n]["launches"] += 1
        elif name in SYNCS and n is not None:
            stages[n]["sync_s"] += (end - t) * 1e-6
        elif name in SYNCS and root_at.at(t) is not None:
            # the glue's waits, by the outermost operator around them
            r0, th, op = root_at.at(t)[0], ops.get(tid, []), "host: no operator"
            for oa, ob, oname in th[bisect.bisect_left(th, (r0,)):]:
                if oa > t or ob >= t:
                    op = oname if oa <= t else op
                    break
            glue_sync[op][0] += (end - t) * 1e-6
            glue_sync[op][1] += 1
    unmatched = 0.0
    for a, b, corr, _ in device:
        call = by_corr.get(corr)
        if call is None:
            unmatched += (b - a) * 1e-6
            continue
        n = stage_of(call[0], call[1])
        if n is not None:
            stages[n]["device_s"] += (b - a) * 1e-6
    covering = _Disjoint(trace._union([(a, b) for a, b, _, _ in stage_spans]))
    root_s = sum(b - a for a, b, _ in roots) * 1e-6
    glue_s = sum((b - a) - covering.covered(a, b) for a, b, _ in roots) * 1e-6

    busy = trace._union([(a, b) for a, b, _, _ in device])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle: Dict[str, float] = defaultdict(float)
    spans.sort()
    nxt, active = 0, []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while nxt < len(spans) and spans[nxt][0] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [s for s in active if s[1] >= mid]
        cover = [(sb - sa, n) for sa, sb, n, _ in active]
        idle[min(cover)[1] if cover else OUTSIDE] += (b - a) * 1e-6
    return {"root": roots[0][2] if roots else None, "roots": len(roots), "root_s": root_s,
            "glue_s": glue_s, "stages": {n: v for n, v in stages.items() if v["count"]},
            "launches": launches, "launches_in_roots": in_roots,
            "kernels": sum(1 for d in device if d[3] == "kernel"),
            "unmatched_device_s": unmatched,
            "glue_sync": sorted(([n, s, c] for n, (s, c) in glue_sync.items()),
                                key=lambda kv: -kv[1]),
            "idle_by_span": sorted(([n, s] for n, s in idle.items()), key=lambda kv: -kv[1])}


def _sum(sp: dict, names: Iterable[str], key: str) -> float:
    return sum(sp["stages"].get(n, {}).get(key, 0.0) for n in names)


def records_roofline(sp: dict, units: List[dict]) -> Optional[float]:
    """100 x the bound of the prefix sum and the expansion (and in a step
    the segment sum) of each traced unit's own records, over the device
    time the ``gs.scan``, ``gs.expand`` (and ``gs.segsum``) spans
    launched; None where they launched nothing."""
    step = sp["root"] == STEP
    names = ("gs.scan", "gs.expand") + (("gs.segsum",) if step else ())
    t = _sum(sp, names, "device_s")
    if t <= 0.0 or not units:
        return None
    work = []
    for u in units:
        work += [rl.prefix(u["splats"]), rl.expand(u["records"], u["splats"])]
        if step:
            work.append(rl.segsum(u["records"], u["splats"]))
    return 100.0 * sum(rl.bound_s(b, f) for b, f in work) / t


def values(sp: dict, units: List[dict]) -> Dict[str, float]:
    """The per-layer numbers of the window: each a mean over its root
    spans; {} where the window holds none (a program without spans)."""
    root, n = sp["root"], sp["roots"]
    if root is None or n == 0:
        return {}
    out = {k: 1000.0 * _sum(sp, names, "host_s") / n for k, names in GROUPS[root].items()}
    unit = "step" if root == STEP else "frame"
    out[f"{unit}_glue_host_ms.{SUFFIX[root]}"] = 1000.0 * sp["glue_s"] / n
    out[f"launches_per_{unit}.{SUFFIX[root]}"] = sp["launches_in_roots"] / n
    share = records_roofline(sp, units)
    if share is not None:
        out[f"records_roofline.{SUFFIX[root]}"] = share
    return out


def lines(sp: dict, units: List[dict]) -> List[str]:
    """What ``main`` prints: a line a stage (host ms, device ms, launches
    and waits, each a mean over the roots), the roots, the glue's waits by
    operator, the idle gaps by span, the values as JSON."""
    n = max(sp["roots"], 1)
    out = [f"span: {name} host_ms {1000.0 * s['host_s'] / n!r} device_ms "
           f"{1000.0 * s['device_s'] / n!r} launches {s['launches'] / n!r} sync_ms "
           f"{1000.0 * s['sync_s'] / n!r} count {s['count'] / n!r}"
           for name, s in sp["stages"].items()]
    stage_ms = 1000.0 * sum(s["host_s"] for s in sp["stages"].values()) / n
    out.append(f"span: roots {sp['roots']} {sp['root']}, mean {1000.0 * sp['root_s'] / n!r} ms"
               f" = stages {stage_ms!r} + glue {1000.0 * sp['glue_s'] / n!r} ms; launch calls "
               f"{sp['launches']}, {sp['launches_in_roots']} inside a root; kernels "
               f"{sp['kernels']}; device seconds matched to no call "
               f"{sp['unmatched_device_s']!r}")
    out.append("glue_sync: " + ", ".join(f"{op} {1000.0 * s / n!r} ms {c / n!r} calls"
                                         for op, s, c in sp["glue_sync"]))
    out.append("idle_by_span: " + ", ".join(f"{name} {s!r} s" for name, s in sp["idle_by_span"]))
    out.append("spans: " + json.dumps(values(sp, units)))
    return out

