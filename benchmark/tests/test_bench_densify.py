"""The ``train-densify`` kind at a tiny size on the CPU: the cell is
correct, each of its faults and its control in bfloat16 is not, and its
four readers read its traces (none where a trace holds no event)."""

from __future__ import annotations

import argparse
import dataclasses

import pytest
import torch
from conftest import run_tiny

from benchmark import calibrate, check, manifest, sut, trace

CELL = "tiny-bicycle-train-densify"
READERS = ("step_mfu_pct.densify", "densify_roofline.densify", "gradstat_roofline.densify",
           "densify_host_ms.densify")


def test_the_tiny_cell_is_correct(tiny):
    res, compared = run_tiny(tiny, CELL)
    assert res["correct"] is True, compared
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert set(compared) == {"loss_gap", "grad_gap", "change_gap", "stat_gap", "alive_gap",
                             "changed_gap", "densify_gap"}


def test_a_traced_run_reads_its_readers(tiny):
    """The tiny mix traces the real mix's 100 steps, which hold one event;
    the two rooflines need a device's kernels, which a CPU run has not."""
    res, compared = run_tiny(tiny, CELL, trace=1)
    assert res["correct"] is True, compared
    assert set(res["metrics"]) == {"step_mfu_pct.densify", "densify_host_ms.densify"}
    for v in res["metrics"].values():
        assert v["value"] == v["value"] and v["value"] > 0.0


@pytest.mark.parametrize("fault", ["no_densify", "world_stat", "stale_moments"])
def test_each_fault_is_not_correct(tiny, fault):
    root, _ = tiny
    program = manifest.kind("train-densify", root).faulty(sut, fault)
    res, compared = run_tiny(tiny, CELL, program=program)
    assert res["correct"] is False, compared


def test_the_reference_in_bfloat16_is_not_correct(tiny):
    root, man = tiny
    args = argparse.Namespace(workload=CELL, seed=11)
    numbers = calibrate.ref_bf16(args, torch.device("cpu"), base=root, man=man)
    ok, compared = check.judge(numbers, manifest.limits(CELL, root))
    assert ok is False, compared


def _records(stages, counters):
    unit = dict(splats=1000, sh_degree=3, records=3000, binned=2500, pixels=4096,
                image_pixels=4000, adam_elements=59000, alive=900, changed=40)
    roots = 4
    return trace.Records(kernels={}, window_s=0.02, busy_s=0.01, units=[unit] * roots,
                         host_s=[], spans={"root": "gs.step", "roots": roots, "stages": stages},
                         counters=counters)


def test_the_readers_on_traces_with_and_without_an_event():
    stat = {"count": 8, "host_s": 4e-4, "device_s": 2e-5, "launches": 32, "sync_s": 0.0}
    event = {"count": 1, "host_s": 1e-3, "device_s": 1e-4, "launches": 40, "sync_s": 0.0}
    counters = {"train.densify.accumulate_grad_stats.calls": 4,
                "train.densify.densify_and_prune.calls": 1}
    rec = _records({"gs.grad_stats": stat, "gs.densify": event}, counters)
    read = {name: manifest.reader(name).read for name in READERS}
    assert read["gradstat_roofline.densify"](rec) == pytest.approx(
        100.0 * 4 * 25 * 1000 / 3.35e12 / 2e-5)
    assert read["densify_roofline.densify"](rec) == pytest.approx(
        100.0 * (58 * 1000 + 16 * 59 * 40) / 3.35e12 / 1e-4)
    assert read["densify_host_ms.densify"](rec) == pytest.approx(1000.0 * 1.4e-3 / 4)
    with_event = read["step_mfu_pct.densify"](rec)

    quiet = _records({"gs.grad_stats": stat},
                     dict(counters, **{"train.densify.densify_and_prune.calls": 0}))
    assert read["densify_roofline.densify"](quiet) is None
    assert read["densify_host_ms.densify"](quiet) is None
    assert read["gradstat_roofline.densify"](quiet) == read["gradstat_roofline.densify"](rec)
    assert 0.0 < read["step_mfu_pct.densify"](quiet) < with_event
    # a program without the adaptive step's spans and counters
    bare = dataclasses.replace(_records({}, {}))
    assert all(read[name](bare) is None for name in READERS)
