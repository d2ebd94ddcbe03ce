"""What later PRs add as files alone: a traffic kind, a scene generator, a
reference and a reader of the port's spans and counters, found by name in
a copy of the benchmark; a generator found under the run's own benchmark
directory; the existing cells' scenes and span values as they were
before; the readers of the records layer and of the counters."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch
from conftest import BENCH, REPO, run_tiny, shrink_config
from frozen_scenes import parent_raw_scene

from benchmark import manifest, scenes, spans, sut, trace

PROGRAM = "openglgaussiansplattingrenderer_tpu_torch"

TOY_GENERATOR = '''
"""A toy scene: splats on a regular grid in the box."""

import torch


def raw_scene(cfg, device):
    n = int(cfg["splats"])
    i = torch.arange(n, device=device, dtype=torch.float32)
    side = round(n ** (1 / 3)) + 1
    grid = torch.stack([i % side, (i // side) % side, i // (side * side)], dim=1)
    ext = float(cfg["scene"]["extent"])
    return {"means": grid / side * 2.0 * ext - ext,
            "log_scales": torch.full((n, 3), -3.0, device=device),
            "quats": torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1),
            "logit_opacities": torch.zeros(n, device=device),
            "colors": torch.full((n, 3), 128.0, device=device)}
'''

TOY_REFERENCE = '''
"""The plain prefix sum of the toy kind."""

import torch


def prefix_sums(counts, dtype=torch.int64):
    return torch.cumsum(counts.to(dtype), 0)
'''

TOY_KIND = '''
"""A toy kind: each unit a prefix sum of per-splat counts in a ``gs.toy``
span, then a frame, both through the program."""

import torch

from benchmark import scenes
from benchmark.cell import Cell
from benchmark.reference import toy_scan

TINY_MIX = {"trace_units": 3}


def counts_of(cfg, seed, device, base):
    raw = scenes.raw_scene(cfg, seed, device, base)
    return raw, ((raw["means"][:, 0] + 4.0) * 3.0).to(torch.int32)


class ToyScan(Cell):
    unit_name = "scan"

    def setup(self):
        raw, self.counts = counts_of(self.cfg, self.seed, self.dev, self.base)
        self.params = scenes.activated(raw)
        self.cam = scenes.camera(self.cfg, 30.0, 10.0)
        self.rcfg = self.program.render_config(self.cfg)
        self.scan = self.program.module("ops.kernels.scan").cumsum
        self.span = self.program.module("utils.timing").span
        self.stamp("toy set-up")
        self.outs = []

    def unit(self, i, timed):
        with self.span("gs.toy"):
            self.outs.append(self.scan(self.counts))
        self.program.render(self.params, self.cam, self.rcfg, self.cfg)
        if timed:
            self.host.append(0.0)

    def finish(self):
        self.sync()

    def tally(self, n, seconds):
        return {"failed": 0, "values": {"scans_per_s": n / seconds}}

    def unit_shapes(self, first, count):
        return [{"splats": int(self.counts.numel())}] * count

    def free(self):
        kept = (self.counts, self.outs[::7])
        self.outs = self.params = None
        return kept

    def reference(self, kept):
        counts, outs = kept
        want = toy_scan.prefix_sums(counts)
        return {"scan_gap": max(float((o.to(torch.int64) - want).abs().max()) for o in outs)}


CELL = ToyScan


def ref_bf16(cfg, mix, seed, device, base):
    _, counts = counts_of(cfg, seed, device, base)
    low = toy_scan.prefix_sums(counts, torch.bfloat16).to(torch.int64)
    return {"scan_gap": float((low - toy_scan.prefix_sums(counts)).abs().max())}


class OffByOne:
    """The program with its prefix sum off by one in its last value."""

    def __init__(self, program):
        self.base = program

    def __getattr__(self, name):
        return getattr(self.base, name)

    def module(self, name):
        mod = self.base.module(name)
        if name != "ops.kernels.scan":
            return mod

        class Scan:
            @staticmethod
            def cumsum(x):
                out = mod.cumsum(x).clone()
                out[-1] += 1
                return out
        return Scan


def faulty(program, mode):
    if mode != "off_by_one":
        raise ValueError(mode)
    return OffByOne(program)
'''

TOY_READER = '''
"""gs.toy spans a frame the program rendered (its eager and replayed
frames' counters)."""

KERNELS = ()


def read(rec):
    toy = rec.spans.get("stages", {}).get("gs.toy")
    frames = rec.counters.get("render.render_arrays.eager", 0) + rec.counters.get(
        "render.render_arrays.replays", 0)
    if not toy or frames <= 0:
        return None
    return toy["count"] / frames
'''

TOY_RUN = '''
import argparse, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import calibrate, check, manifest, run, sut

out = {"run": run.__file__}
for trace in (0, 1):
    run.T0 = time.perf_counter()
    args = argparse.Namespace(workload="toy-cell", seed=2 ** 40 + 3, seconds=0.2, trace=trace)
    res, _ = run.run_cell(args, torch.device("cpu"))
    out[f"trace{trace}"] = res
args = argparse.Namespace(workload="toy-cell", seed=5, seconds=0.2, trace=0)
run.T0 = time.perf_counter()
res, _ = run.run_cell(args, torch.device("cpu"),
                      program=calibrate.planted(sut, "off_by_one", args))
out["fault"] = res["correct"]
numbers = calibrate.ref_bf16(args, torch.device("cpu"))
out["control"] = check.judge(numbers, manifest.limits("toy-cell"))[0]
print(json.dumps(out))
'''


def test_a_kind_generator_reference_and_reader_are_added_as_files(tmp_path):
    """A copy of the benchmark, with a toy kind, generator, reference,
    reader, configuration, mix, limits and manifest entries added as files;
    no file that was there changes, and the toy cell runs through them."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / PROGRAM, tmp_path / PROGRAM)
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    assert all(p.read_bytes() == (BENCH / p.relative_to(tmp_path / "benchmark")).read_bytes()
               for p in before)
    b = tmp_path / "benchmark"
    for sub, name, text in (("generators", "toy-grid", TOY_GENERATOR),
                            ("reference", "toy_scan", TOY_REFERENCE),
                            ("kinds", "toy-scan", TOY_KIND),
                            ("metrics", "toy_spans_per_frame.toy", TOY_READER)):
        (b / sub).mkdir(exist_ok=True)
        (b / sub / f"{name}.py").write_text(textwrap.dedent(text).lstrip())
    cfg = shrink_config(json.loads((BENCH / "configs" / "bike-big.json").read_text()))
    cfg.update(name="toy", splats=600)
    cfg["scene"] = {"generator": "toy-grid", "structure_seed": 1, "extent": 2.0}
    (b / "configs" / "toy.json").write_text(json.dumps(cfg))
    (b / "traffic" / "toy-scan.json").write_text(json.dumps(
        {"kind": "toy-scan", "why": "a toy", "trace_units": 3}))
    (b / "limits" / "toy-cell.json").write_text(json.dumps({"limits": {"scan_gap": 0.0}}))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy", "source": "a toy", "file": "benchmark/configs/toy.json",
                           "reduced": [], "why": "a toy"})
    man["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toy-scan",
                             "chips": 1, "why": "a toy"})
    man["end_to_end"].append({"name": "scans_per_s", "unit": "scans/s", "better": "higher",
                              "bound": 0.25, "source": "host_clock", "workloads": ["toy-cell"]})
    man["per_layer"].append({"name": "toy_spans_per_frame.toy", "unit": "spans/frame",
                             "better": "higher", "source": "program_span", "layer": "toy",
                             "moves": "scans_per_s", "workloads": ["toy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    got = subprocess.run([sys.executable, "-c", TOY_RUN, str(tmp_path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["run"].startswith(str(tmp_path))
    untraced, traced = out["trace0"], out["trace1"]
    assert untraced["correct"] is True and traced["correct"] is True, out
    assert set(untraced["metrics"]) == {"scans_per_s", "setup_s"}
    assert traced["metrics"] == {"toy_spans_per_frame.toy": {"value": 1.0,
                                                             "unit": "spans/frame"}}
    assert out["fault"] is False and out["control"] is False
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("config", ["bike-big", "mipnerf360-bicycle"])
def test_the_clustered_scenes_are_as_before(config):
    cfg = shrink_config(manifest.config(config))
    for seed in (2 ** 33 + 5, 17):
        new = scenes.raw_scene(cfg, seed, torch.device("cpu"))
        old = parent_raw_scene(cfg, seed, torch.device("cpu"))
        assert list(new) == list(old)
        assert all(torch.equal(new[k], old[k]) for k in old), config


def test_span_values_are_as_before_on_a_recorded_tiny_trace():
    """Tiny traced runs recorded before every gs.* span was read as a
    stage: the same stages and values, and a span the port might add is
    read under its own name with no other value moved."""
    rec = json.loads((BENCH / "tests" / "data" / "tiny_spans.json").read_text())
    for cell, r in rec.items():
        sp = spans.reduce_spans(r["events"])
        assert sorted(sp["stages"]) == r["stages"], cell
        assert spans.values(sp, r["units"]) == pytest.approx(r["values"]), cell
        win = next(e for e in r["events"] if e["name"] == trace.WINDOW)
        first = min(e["ts"] for e in r["events"] if e["name"] in (spans.FRAME, spans.STEP))
        extra = dict(win, name="gs.densify", ts=win["ts"] + 1.0, dur=first - win["ts"] - 2.0)
        sp = spans.reduce_spans(r["events"] + [extra])
        assert list(sp["stages"])[-1] == "gs.densify"
        assert sp["stages"]["gs.densify"]["count"] == 1
        assert spans.values(sp, r["units"]) == pytest.approx(r["values"]), cell


CLUSTERED_ELSEWHERE = '''
"""The configuration's clustered scene, in the order of seed 0."""

from benchmark import scenes


def raw_scene(cfg, device):
    return scenes.raw_scene(dict(cfg, scene=dict(cfg["scene"], generator="clustered")), 0,
                            device)
'''


def test_a_generator_is_found_under_the_runs_own_directory(tiny, tmp_path):
    """A generator file under a benchmark directory other than the
    package's own: ``raw_scene`` finds it under the ``base`` it is given,
    and a cell run with that ``base`` makes its scene, warms up, renders
    and checks through it; the package's own directory has no such file."""
    root, man = tiny
    base = tmp_path / "bench"
    shutil.copytree(root, base)
    (base / "generators").mkdir(exist_ok=True)
    (base / "generators" / "clustered-elsewhere.py").write_text(
        textwrap.dedent(CLUSTERED_ELSEWHERE).lstrip())
    cfg = json.loads((base / "configs" / "bike-big.json").read_text())
    cfg["scene"]["generator"] = "clustered-elsewhere"
    cfg["name"] = "bike-big-elsewhere"
    (base / "configs" / "bike-big-elsewhere.json").write_text(json.dumps(cfg))
    cpu, seed = torch.device("cpu"), 2 ** 34 + 9
    got = scenes.raw_scene(cfg, seed, cpu, base)
    # the generator's rows (seed 0's order), put in the run's own order
    first = scenes.raw_scene(manifest.config("bike-big", root), 0, cpu)
    perm = torch.randperm(cfg["splats"], generator=scenes.generator(seed, cpu))
    assert list(got) == list(first)
    assert all(torch.equal(got[k], first[k][perm]) for k in first)
    with pytest.raises(FileNotFoundError):
        scenes.raw_scene(cfg, seed, cpu)
    man = json.loads(json.dumps(man))
    man["configs"].append(dict(man["configs"][0], name="bike-big-elsewhere"))
    man["workloads"].append({"name": "tiny-elsewhere-view", "config": "bike-big-elsewhere",
                             "traffic": "orbit", "chips": 1, "why": "a generator elsewhere"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "tiny-bikebig-view" in m.get("workloads", ()):
            m["workloads"].append("tiny-elsewhere-view")
    shutil.copy(base / "limits" / "tiny-bikebig-view.json",
                base / "limits" / "tiny-elsewhere-view.json")
    res, compared = run_tiny((base, man), "tiny-elsewhere-view", seed=seed)
    assert res["correct"] is True, compared
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}


def test_the_program_is_reached_by_module_and_counted_by_counters(monkeypatch):
    densify = sut.module("train.densify")
    assert densify.__name__ == PROGRAM + ".train.densify"
    for bad in ("", ".render", "..io", "os/path", "render.", "1x", "render..io"):
        with pytest.raises(ValueError):
            sut.module(bad)
    for name in ("ops.kernels.scan", "ops.kernels.records", "ops.kernels.table",
                 "ops.kernels.adam"):
        sut.module(name)      # counters are read from the modules loaded
    c = sut.counters()
    assert {"ops.kernels.scan.cumsum.launches", "ops.kernels.records.expand.launches",
            "ops.kernels.table.splat_table.launches", "ops.kernels.adam.adam_update.launches",
            "render.render_arrays.captures", "render.render_arrays.replays",
            "render.render_arrays.eager", "render.render_arrays.capture_failures"} <= set(c)
    assert all(type(v) is int for v in c.values())
    # a counter the port adds is found with no edit to the harness
    monkeypatch.setattr(densify.densify_and_prune, "clones", 7, raising=False)
    assert sut.counters()["train.densify.densify_and_prune.clones"] == 7


def test_the_counters_of_a_traced_segment_are_its_change(tiny):
    """Records.counters holds what the traced frames added, not the
    counters' totals."""
    got = {}
    records = trace.Records

    def keep(**kw):
        got["rec"] = records(**kw)
        return got["rec"]

    trace.Records = keep
    try:
        run_tiny(tiny, "tiny-bikebig-view", trace=1)
    finally:
        trace.Records = records
    c = got["rec"].counters
    assert c["render.render_arrays.eager"] == 2 and c["render.render_arrays.replays"] == 0
    assert got["rec"].spans["root"] == spans.FRAME and got["rec"].spans["roots"] == 2


def test_the_records_readers():
    """The frame's and the step's readers of the records layer, both by
    kernel names (a replayed frame has no stage span), and the graph's
    hit share from the counters."""
    unit = dict(splats=1000, records=3000)
    kernels = {"void scan_lookback<int>(...)": 10e-6, "expand_records(float const*)": 30e-6,
               "void segsum<9>(float const*)": 50e-6, "segsum_carries(float*)": 5e-6,
               "radix_scatter<8>": 1.0}
    rec = trace.Records(kernels=kernels, window_s=0.01, busy_s=0.001, units=[unit], host_s=[])
    frame = manifest.reader("records_roofline.render")
    frame_only = {k: t for k, t in kernels.items() if "segsum" not in k}
    want = 100.0 * (8 * 1000 + 16 * 3000 + 24 * 1000) / 3.35e12 / 40e-6
    assert frame.read(dataclasses.replace(rec, kernels=frame_only)) == pytest.approx(want)
    step = manifest.reader("records_roofline.train")
    want = 100.0 * (8 * 1000 + 16 * 3000 + 24 * 1000 + 36 * 3000 + 40 * 1000) / 3.35e12 / 95e-6
    assert step.read(rec) == pytest.approx(want)
    for reader in (frame, step):
        assert reader.read(dataclasses.replace(rec, kernels={"radix_scatter<8>": 1.0})) is None
    hits = manifest.reader("graph_hit_share.render")
    rec.counters = {"render.render_arrays.replays": 359, "render.render_arrays.eager": 1}
    assert hits.read(rec) == pytest.approx(100.0 * 359 / 360)
    rec.counters = {}
    assert hits.read(rec) is None
