#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names a
configuration (``benchmark/configs/<name>.json``: the scene, its size, the
frame, the camera, the training views and rates) and a traffic mix
(``benchmark/traffic/<name>.json``) of one of two kinds:

- ``orbit``: one viewer in a closed loop, a new pose on the ring each
  frame; each frame is handed to ``render_arrays`` and waited for
  (``torch.cuda.synchronize``), as a viewer waits before it shows it.
- ``train``: the trainer's loop; each step the next view of a seeded
  shuffle of the training views, dispatched back to back, the loss read
  to the host every ``readback_every`` steps and at the window's end.

The run makes the scene and every input on the device from ``--seed``,
warms up every shape it will use (set-up), measures for ``--seconds``,
then checks what the timed path produced against the plain reference
(``benchmark/reference``). With ``--trace 1``, ``trace_units`` frames or
steps run under torch.profiler before the measured window, and the
per-layer readers (``benchmark/metrics/<name>.py``) take their numbers from
that timeline; the window then gives the host's enqueue times. The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.

Exits non-zero, printing no result, without a CUDA device, and where JAX
or the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

BANNED = ("jax", "jaxlib", "flax", "openglgaussiansplattingrenderer_tpu", "gsplat_tpu")


def banned_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stamp(what: str) -> None:
    log(f"setup: {what} at {time.perf_counter() - T0:.3f} s")


class Cell:
    """What the two kinds of traffic share: the device, the clock, the
    per-unit shapes the rooflines read, the host's enqueue spans."""

    def __init__(self, cfg, mix, seed, device, program):
        import torch

        self.torch = torch
        self.cfg, self.mix, self.seed, self.dev, self.program = cfg, mix, seed, device, program
        self.cuda = device.type == "cuda"
        self.host = []

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def shapes(self, num_records, binned) -> dict:
        from benchmark.reference.render import frame_of

        fr = frame_of(self.cfg)
        return {"splats": int(self.cfg["splats"]), "sh_degree": int(self.cfg["sh_degree"]),
                "records": int(num_records), "binned": int(binned),
                "pixels": fr.tiles * fr.pixels_per_tile,
                "image_pixels": fr.width * fr.height}


class Orbit(Cell):
    unit_name = "frame"

    def setup(self):
        from benchmark import scenes

        cfg, mix, p = self.cfg, self.mix, self.program
        self.params = scenes.activated(scenes.raw_scene(cfg, self.seed, self.dev))
        self.poses = int(mix["poses"])
        self.cams = scenes.orbit(cfg, mix, self.seed % self.poses)
        self.sync()
        stamp("scene")
        self.rcfg = p.autotune(self.params, self.cams, p.render_config(cfg), cfg,
                               float(mix["capacity_margin"]))
        stamp(f"capacity {self.rcfg.capacity_records}")
        self.sample = set(random.Random(self.seed).sample(range(int(mix["sample_span"])),
                                                          int(mix["sample_frames"])))
        for i in range(int(mix["warmup_frames"])):
            p.render(self.params, self.cams[(i * 37) % self.poses], self.rcfg, cfg)
        self.sync()
        self.kept, self.stats, self.lat = {}, [], []

    def unit(self, i: int, timed: bool):
        torch = self.torch
        cam = self.cams[i % self.poses]
        if timed and self.cuda:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        img, st = self.program.render(self.params, cam, self.rcfg, self.cfg)
        t1 = time.perf_counter()
        if timed and self.cuda:
            e1.record()
        self.sync()
        if timed:
            self.lat.append((e0, e1) if self.cuda else time.perf_counter() - t0)
            self.host.append(t1 - t0)
        self.stats.append((st["overflow"], st["num_records"], st["binned_records"]))
        if i in self.sample:
            self.kept[i] = (img, st["num_records"])

    def finish(self):
        self.sync()

    def tally(self, n: int, seconds: float) -> dict:
        torch = self.torch
        s = torch.stack([torch.stack([a.to(torch.int64) for a in row]) for row in self.stats])
        self.counts = s.cpu()
        failed = int((self.counts[:, 0] > 0).sum())
        lat = [e0.elapsed_time(e1) for e0, e1 in self.lat] if self.cuda else \
            [1000.0 * x for x in self.lat]
        out = {"frames_per_s": n / seconds}
        if lat:
            out["frame_ms_p95"] = percentile(lat, 95.0)
        return {"failed": failed, "values": out}

    def unit_shapes(self, first: int, count: int):
        return [self.shapes(self.counts[i, 1], self.counts[i, 2])
                for i in range(first, first + count)]

    def free(self):
        kept = {i: (img, int(n)) for i, (img, n) in self.kept.items()}
        for name in ("params", "rcfg", "stats", "lat", "kept"):
            setattr(self, name, None)
        return kept

    def reference(self, kept):
        from benchmark import check, scenes
        from benchmark.reference import render as rr

        params = scenes.activated(scenes.raw_scene(self.cfg, self.seed, self.dev))
        fr = rr.frame_of(self.cfg)
        pairs = []
        for i, (img, n) in sorted(kept.items()):
            ref, total = rr.render(params, self.cams[i % self.poses], fr)
            pairs.append((img, n, ref, total))
        return check.frame_numbers(pairs)


class Train(Cell):
    unit_name = "step"

    def setup(self):
        from benchmark import check, scenes

        cfg, mix, p = self.cfg, self.mix, self.program
        raw0 = scenes.raw_scene(cfg, self.seed, self.dev)
        self.keys = list(raw0)
        self.views = scenes.training_views(cfg)
        self.targets = scenes.targets(cfg, len(self.views), self.seed, self.dev)
        self.sync()
        stamp("scene and targets")
        rcfg = p.autotune(scenes.activated(raw0), self.views, p.render_config(cfg), cfg,
                          float(mix["capacity_margin"]))
        self.rcfg = rcfg
        stamp(f"capacity {rcfg.capacity_records}")
        self.step = p.make_step(cfg, rcfg, self.keys)
        self.bundles = p.bundles(self.views, self.dev)
        self.rng, self.stack = random.Random(self.seed), []
        self.readback = int(mix["readback_every"])
        self.state = self.step.init({k: v.clone() for k, v in raw0.items()})
        # the first steps go through the window's own call and feed; the
        # reference follows them once the window has closed
        self.checked, self.prog_losses = [], []
        for j in range(int(mix["checked_steps"])):
            v = self.next_view()
            self.state, m = self.step(self.state, self.targets[v], *self.bundles[v])
            self.checked.append(v)
            self.prog_losses.append(float(m["loss"]))
            if j == 0:   # Adam's first moment after one step is (1 - b1) g
                mu = p.moments(self.state)
                self.prog_grad = {k: check.norm(mu[k]) / 0.1 for k in self.keys}
        self.prog_change = {k: check.norm(self.state.raw[k] - raw0[k]) for k in self.keys}
        stamp("checked steps")
        del raw0
        for _ in range(int(mix["warmup_steps"])):
            v = self.next_view()
            self.state, m = self.step(self.state, self.targets[v], *self.bundles[v])
        float(m["loss"])
        self.sync()
        self.losses, self.done = [], []

    def next_view(self) -> int:
        if not self.stack:
            self.stack = list(range(len(self.views)))
            self.rng.shuffle(self.stack)
        return self.stack.pop()

    def unit(self, i: int, timed: bool):
        v = self.next_view()
        t0 = time.perf_counter()
        self.state, m = self.step(self.state, self.targets[v], *self.bundles[v])
        t1 = time.perf_counter()
        if timed:
            self.host.append(t1 - t0)
        self.losses.append(m["loss"])
        self.done.append(v)
        if (len(self.losses)) % self.readback == 0:
            float(m["loss"])

    def finish(self):
        self.sync()
        if self.losses:
            float(self.losses[-1])

    def tally(self, n: int, seconds: float) -> dict:
        torch = self.torch
        ls = torch.stack(self.losses).cpu() if self.losses else torch.zeros(0)
        return {"failed": int((~torch.isfinite(ls)).sum()),
                "values": {"train_steps_per_s": n / seconds}}

    def unit_shapes(self, first: int, count: int):
        """Each traced step's shapes: its view's records under the
        parameters the window ended with (one frame a view, after the
        window)."""
        from benchmark.reference.train import params_from_raw

        torch = self.torch
        with torch.no_grad():
            params = params_from_raw(self.state.raw)
            seen = {}
            for v in self.done[first:first + count]:
                if v not in seen:
                    _, st = self.program.render(params, self.views[v], self.rcfg, self.cfg)
                    seen[v] = (int(st["num_records"]), int(st["binned_records"]))
        elements = sum(int(t.numel()) for t in self.state.raw.values())
        return [dict(self.shapes(*seen[v]), adam_elements=elements)
                for v in self.done[first:first + count]]

    def free(self):
        kept = [(self.targets[v].clone(), self.views[v]) for v in self.checked]
        for name in ("state", "step", "bundles", "targets", "losses", "rcfg"):
            setattr(self, name, None)
        return kept

    def reference(self, kept):
        from benchmark import check, scenes
        from benchmark.reference import train as rt

        raw0 = scenes.raw_scene(self.cfg, self.seed, self.dev)
        losses, first, change = rt.run_steps(raw0, kept, self.cfg, len(kept))
        ref_grad = {k: check.norm(first[k]) for k in self.keys}
        ref_change = {k: check.norm(change[k]) for k in self.keys}
        return check.step_numbers(self.prog_losses, self.prog_grad, self.prog_change,
                                  losses, ref_grad, ref_change)


KINDS = {"orbit": Orbit, "train": Train}


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the nearest ranks."""
    v = sorted(values)
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def traced_segment(cell, units: int):
    """Run ``units`` frames or steps under torch.profiler; returns the
    reduced timeline and the CUDA events' seconds around the same units."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cell.cuda else [])
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            if cell.cuda:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            for i in range(units):
                cell.unit(i, timed=False)
            cell.finish()
            if cell.cuda:
                e1.record()
                cell.sync()
    events_s = e0.elapsed_time(e1) / 1000.0 if cell.cuda else None
    t0 = time.perf_counter()
    reduced = trace.read_profile(prof)
    log(f"trace: read in {time.perf_counter() - t0:.3f} s")
    return reduced, events_s


def run_cell(args, device, base: Path = HERE, man: dict | None = None, program=None):
    """Run the cell ``args.workload`` once on ``device``. Returns (the
    result dict, the compared numbers {name: [number, limit]})."""
    import torch

    from benchmark import check, manifest, roofline, trace

    man = man if man is not None else manifest.load()
    wl = manifest.workload(man, args.workload)
    cfg, mix = manifest.config(wl["config"], base), manifest.mix(wl["traffic"], base)
    e2e, layer = manifest.metrics_of(man, wl["name"])
    if program is None:
        from benchmark import sut as program
    cell = KINDS[mix["kind"]](cfg, mix, args.seed, device, program)
    stamp("imports")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell.setup()
    setup_s = time.perf_counter() - T0
    log(f"setup: {setup_s!r} s")

    # the traced frames or steps come first, and the reading of their
    # timeline; the measured window starts after both
    traced, events_s, first = None, None, 0
    if args.trace:
        first = int(mix["trace_units"])
        traced, events_s = traced_segment(cell, first)
    n = first
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < args.seconds:
        cell.unit(n, timed=True)
        n += 1
    cell.finish()
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = banned_modules()
    if found:
        raise SystemExit(f"banned modules loaded by the window's close: {found}")
    tally = cell.tally(n - first, window_s)

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": n, "failed": tally["failed"], "metrics": {},
              "device": device_info}
    if args.trace:
        rec = trace.Records(kernels=traced["kernels"], window_s=traced["window_s"],
                            busy_s=traced["busy_s"], units=cell.unit_shapes(0, first),
                            host_s=list(cell.host), power=roofline.power_limit() if cuda else "",
                            device_ops=traced["device_ops"], idle_gaps=traced["idle_gaps"])
        readers = {m["name"]: manifest.reader(m["name"], base) for m in layer}
        for m in layer:
            v = readers[m["name"]].read(rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=rec.busy_s, window_s=rec.window_s)
        result["breakdown"] = {"device_ops": rec.device_ops, "idle_gaps": rec.idle_gaps}
        maps = [getattr(r, "KERNELS", ()) for r in readers.values()]
        for name, t in roofline.unattributed(rec.kernels, maps):
            log(f"unattributed: {t!r} s {name[:160]}")
        log(f"trace: {first} {cell.unit_name}s, window {rec.window_s!r} s, profiler busy "
            f"{rec.busy_s!r} s, kernels {sum(rec.kernels.values())!r} s, CUDA events "
            f"{events_s!r} s; card {rec.power}")
    else:
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" else tally["values"].get(m["name"])
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}

    kept = cell.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = cell.reference(kept)
    log(f"reference: {time.perf_counter() - t_ref!r} s for {len(kept)} {cell.unit_name}s; "
        f"window {window_s!r} s, {n} {cell.unit_name}s")
    ok, compared = check.judge(numbers, manifest.limits(wl["name"], base))
    result["correct"] = ok
    result["check"] = compared
    return result, compared


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import torch

        from benchmark import manifest

        chips = int(manifest.workload(manifest.load(), args.workload)["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"no CUDA device for {chips} chip(s): cuda available "
                f"{torch.cuda.is_available()}, {torch.cuda.device_count()} device(s)")
            return 2
        result, compared = run_cell(args, torch.device("cuda", 0))
    except SystemExit as e:
        log(str(e))
        return 3
    except Exception:  # the run failed: say why, print no result
        log(traceback.format_exc())
        return 1
    found = banned_modules()
    if found:
        log(f"banned modules loaded: {found}")
        return 3
    for k, (v, cap) in compared.items():
        log(f"check: {k} {v!r} <= {cap!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
