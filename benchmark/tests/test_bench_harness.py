"""The harness on the CPU at a tiny size: the result line, discovery by
name, what it refuses to run, what it loads, and that ``correct`` comes
out false with the timed path broken underneath or lowered in precision."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, REPO, run_tiny

from benchmark import faults, manifest, sut
from benchmark.reference import render as rr

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny-bikebig-view", "tiny-bicycle-train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_required_keys(tiny, cell, trace):
    res, compared = run_tiny(tiny, cell, trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(res) == want
    assert res["correct"] is True, compared
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 1
    e2e, layer = manifest.metrics_of(tiny[1], cell)
    names = {m["name"] for m in (layer if trace else e2e)}
    assert set(res["metrics"]) <= names and res["metrics"]
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] == v["value"]
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"]
    json.dumps(res)


def test_a_new_config_mix_metric_and_cell_are_found_by_name(tiny, tmp_path):
    """Added as files and manifest entries, with no edit to a file that
    is there."""
    root, man = tiny
    base = tmp_path / "bench"
    shutil.copytree(root, base)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "bike-big.json").read_text())
    cfg.update(name="tiny-new", splats=1500)
    (base / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "orbit.json").read_text())
    mix.update(elevation_deg=15.0)
    (base / "traffic" / "orbit-high.json").write_text(json.dumps(mix))
    (base / "metrics" / "frames_traced.render.py").write_text(
        "KERNELS = ()\n\n\ndef read(rec):\n    return float(len(rec.units))\n")
    (base / "limits" / "tiny-new-view.json").write_text(json.dumps(
        {"limits": {"records_gap": 0.0, "img_max_gap": 0.05, "img_mean_gap": 1e-3}}))
    man = json.loads(json.dumps(man))
    man["workloads"].append({"name": "tiny-new-view", "config": "tiny-new",
                             "traffic": "orbit-high", "chips": 1, "why": "added by data"})
    for m in man["end_to_end"]:
        if "frames_per_s" == m["name"] or "frame_ms_p95" == m["name"]:
            m["workloads"].append("tiny-new-view")
    man["per_layer"].append({"name": "frames_traced.render", "unit": "frames",
                             "better": "higher", "source": "device_trace", "layer": "device",
                             "moves": "frames_per_s", "workloads": ["tiny-new-view"]})
    res, compared = run_tiny((base, man), "tiny-new-view", trace=1)
    assert res["correct"] is True, compared
    assert res["metrics"]["frames_traced.render"]["value"] == 2.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_cpu_only_process_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bikebig-view",
                          "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_only_the_benchmark_cannot_run(tmp_path):
    """A directory with BENCHMARK.json and the files under ``paths`` alone
    has no program to run: the run exits non-zero with no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-c",
                          "import sys; sys.path.insert(0, '.'); from benchmark import run; "
                          "sys.exit(run.main(['--workload', 'bikebig-view', '--seed', '5', "
                          "'--seconds', '1']))"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_harness_loads_neither_jax_nor_the_jax_package(tiny, tmp_path):
    """Every module a tiny run loads, compared by its whole top-level name."""
    root, man = tiny
    (tmp_path / "man.json").write_text(json.dumps(man))
    code = f"""
import argparse, json, sys, time
sys.path.insert(0, {str(REPO)!r})
import torch
from benchmark import run
man = json.load(open({str(tmp_path / 'man.json')!r}))
for cell, trace in (("tiny-bikebig-view", 1), ("tiny-bicycle-train", 0)):
    run.T0 = time.perf_counter()
    args = argparse.Namespace(workload=cell, seed=3, seconds=0.2, trace=trace)
    run.run_cell(args, torch.device("cpu"), base=__import__("pathlib").Path({str(root)!r}), man=man)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "openglgaussiansplattingrenderer_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "openglgaussiansplattingrenderer_tpu",
                      "gsplat_tpu"}


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "openglgaussiansplattingrenderer_tpu_torch_x", sys)
    assert "openglgaussiansplattingrenderer_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_modules() == ["jax"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-bicycle-train", "unchanged"),
    ("tiny-bicycle-train", "half_batch"),
    ("tiny-bicycle-train", "altered"),
    ("tiny-bikebig-train", "unchanged"),
    ("tiny-bikebig-train", "half_batch"),
    ("tiny-bikebig-view", "altered"),
    ("tiny-bicycle-view", "altered"),
])
def test_a_fault_under_the_timed_path_is_not_correct(tiny, cell, fault):
    res, compared = run_tiny(tiny, cell, program=faults.Faulty(sut, fault))
    assert res["correct"] is False, compared


@pytest.mark.parametrize("cell,control", [
    ("tiny-bicycle-train", "bwd_bf16"),
    ("tiny-bikebig-train", "bwd_bf16"),
    ("tiny-bikebig-view", "q16"),
])
def test_the_programs_lower_precision_path_is_not_correct(tiny, cell, control):
    """The control: the program with its own lower-precision path on."""
    res, compared = run_tiny(tiny, cell, program=faults.Faulty(sut, control))
    assert res["correct"] is False, compared


def test_the_reference_in_bfloat16_is_not_correct(tiny):
    """The control where the program has no lower path (1,014 tiles hold
    no q16 key): the reference in bfloat16 in the program's place."""
    from benchmark import calibrate, check

    root, man = tiny
    args = argparse.Namespace(workload="tiny-bicycle-view", seed=11)
    numbers = calibrate.ref_bf16(args, torch.device("cpu"), base=root, man=man)
    ok, compared = check.judge(numbers, manifest.limits("tiny-bicycle-view", root))
    assert ok is False, compared
    assert rr.Precision(torch.bfloat16)(torch.tensor([1.0 + 2 ** -10])).item() == 1.0


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """On a machine with a card: one cell once, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bikebig-view",
                          "--seed", str(2 ** 33 + 1), "--seconds", "2", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
