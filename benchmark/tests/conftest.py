"""Fixtures of the benchmark's tests: a tiny copy of the benchmark's data
(configurations scaled down, mixes shortened, every metric reader and
limits file copied) in a temporary directory, and a runner of its cells
on the CPU, where the program runs its plain versions."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# each real cell and the tiny cell that stands in for it
TINY = {"bicycle-train": "tiny-bicycle-train", "bikebig-view": "tiny-bikebig-view",
        "bicycle-view": "tiny-bicycle-view", "bikebig-train": "tiny-bikebig-train"}


def shrink_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg.update(splats=2500, width=72, height=40)
    cfg["render"]["tile_px"] = 16
    cfg["views"]["count"] = 12
    return cfg


def shrink_mix(mix: dict) -> dict:
    mix = dict(mix)
    if mix["kind"] == "orbit":
        mix.update(poses=12, degrees_per_frame=30.0, warmup_frames=1, sample_span=2,
                   sample_frames=2, trace_units=2)
    else:
        mix.update(readback_every=2, warmup_steps=1, trace_units=2)
    return mix


def build_tiny(root: Path) -> dict:
    """The tiny benchmark under ``root``; returns its manifest."""
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "metrics", dirs_exist_ok=True)
    for c in man["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        (root / "configs" / f"{c['name']}.json").write_text(json.dumps(shrink_config(cfg)))
    for w in man["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        (root / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(shrink_mix(mix)))
        lim = BENCH / "limits" / f"{w['name']}.json"
        if lim.exists():
            shutil.copy(lim, root / "limits" / f"{TINY[w['name']]}.json")
        w["name"] = TINY[w["name"]]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY[w] for w in m["workloads"]]
    return man


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tinybench")
    return root, build_tiny(root)


def run_tiny(tiny, cell: str, seed: int = 2 ** 33 + 7, trace: int = 0, seconds: float = 0.3,
             program=None):
    """One run of a tiny cell on the CPU: (result, compared numbers)."""
    from benchmark import run

    root, man = tiny
    torch.set_num_threads(2)
    run.T0 = time.perf_counter()
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return run.run_cell(args, torch.device("cpu"), base=root, man=man, program=program)
