"""The program's ``gs.*`` spans reduced to stages: a timeline worked out by
hand, and a tiny cell traced on the CPU."""

from __future__ import annotations

import json

import pytest
from conftest import run_tiny

from benchmark import roofline as rl, spans, trace


def x(name, ts, dur, cat="user_annotation", tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# a step on thread 1, its backward stages on thread 2 (the autograd
# engine's), launch calls and the device work they launched, joined by
# correlation, and idle gaps under several spans and outside the program
STEP_EVENTS = [
    x(trace.WINDOW, 0, 10000),
    x("gs.step", 100, 5000), x("gs.frame", 150, 1650),
    x("gs.table", 200, 500), x("gs.scan", 800, 100), x("gs.loss", 2000, 300),
    x("gs.adam", 4500, 450),
    x("gs.composite.bwd", 2500, 500, tid=2), x("gs.segsum", 3100, 200, tid=2),
    x("cudaLaunchKernel", 300, 5, "cuda_runtime", corr=1),
    x("cudaLaunchKernel", 850, 5, "cuda_runtime", corr=2),
    x("cudaMemsetAsync", 860, 5, "cuda_runtime", corr=3),
    x("cuLaunchKernel", 2600, 5, "cuda_driver", tid=2, corr=4),
    x("cudaLaunchKernel", 2700, 5, "cuda_runtime", corr=5),   # thread 1: glue
    x("cudaLaunchKernel", 6000, 5, "cuda_runtime", corr=6),   # outside the step
    x("cudaLaunchKernelExC", 3200, 5, "cuda_runtime", tid=2, corr=7),
    x("table_kernel", 1000, 400, "kernel", tid=7, corr=1),
    x("scan_kernel", 1500, 100, "kernel", tid=7, corr=2),
    x("Memset (Device)", 1600, 50, "gpu_memset", tid=7, corr=3),
    x("composite_bwd", 3000, 500, "kernel", tid=7, corr=4),
    x("glue_kernel", 3600, 100, "kernel", tid=7, corr=5),
    x("late_kernel", 6100, 100, "kernel", tid=7, corr=6),
    x("segsum", 3500, 100, "kernel", tid=7, corr=7),
    x("lost_kernel", 9000, 100, "kernel", tid=7, corr=99),
    x("gs.table", 200, 500, "gpu_user_annotation", tid=7),
    # waits: one in the loss, one under an operator of the glue, one bare
    x("cudaStreamSynchronize", 2100, 50, "cuda_runtime", corr=51),
    x("aten::to", 4000, 300, "cpu_op"), x("aten::copy_", 4050, 200, "cpu_op"),
    x("cudaStreamSynchronize", 4100, 100, "cuda_runtime", corr=50),
    x("cudaStreamSynchronize", 1900, 20, "cuda_runtime", corr=52),
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 3},
]


def test_a_step_by_hand():
    sp = spans.reduce_spans(STEP_EVENTS)
    assert sp["root"] == "gs.step" and sp["roots"] == 1
    assert sp["root_s"] == pytest.approx(5000e-6)
    want = {"gs.table": (500, 1, 400), "gs.scan": (100, 1, 150), "gs.loss": (300, 0, 0),
            "gs.adam": (450, 0, 0), "gs.composite.bwd": (500, 1, 500),
            "gs.segsum": (200, 1, 100)}
    assert set(sp["stages"]) == set(want)
    for name, (host, launches, dev) in want.items():
        s = sp["stages"][name]
        assert s["count"] == 1 and s["launches"] == launches, name
        assert s["host_s"] == pytest.approx(host * 1e-6), name
        assert s["device_s"] == pytest.approx(dev * 1e-6), name
    # the step less its stages on both threads: 5000 - 2050 us
    assert sp["glue_s"] == pytest.approx(2950e-6)
    assert sum(s["host_s"] for s in sp["stages"].values()) + sp["glue_s"] == \
        pytest.approx(sp["root_s"])
    assert (sp["launches"], sp["launches_in_roots"], sp["kernels"]) == (6, 5, 7)
    assert sp["unmatched_device_s"] == pytest.approx(100e-6)
    assert sp["stages"]["gs.loss"]["sync_s"] == pytest.approx(50e-6)
    assert sp["glue_sync"] == [["aten::to", pytest.approx(100e-6), 1],
                               ["host: no operator", pytest.approx(20e-6), 1]]
    idle = dict(sp["idle_by_span"])
    assert list(idle) == [spans.OUTSIDE, "gs.adam", "gs.step", "gs.table", "gs.frame"]
    for name, us in ((spans.OUTSIDE, 2800 + 900), ("gs.adam", 2400), ("gs.step", 1350),
                     ("gs.table", 1000), ("gs.frame", 100)):
        assert idle[name] == pytest.approx(us * 1e-6), name
    # the device's idle time, whoever it is put down to
    dev = trace.reduce_events(STEP_EVENTS)
    assert sum(idle.values()) == pytest.approx(dev["window_s"] - dev["busy_s"])


def test_a_step_values():
    sp = spans.reduce_spans(STEP_EVENTS)
    unit = dict(splats=1000, records=3000)
    got = spans.values(sp, [unit])
    assert got == {
        "table_host_ms.train": pytest.approx(0.5), "records_host_ms.train": pytest.approx(0.3),
        "sort_host_ms.train": 0.0, "composite_host_ms.train": pytest.approx(0.5),
        "loss_host_ms.train": pytest.approx(0.3), "adam_host_ms.train": pytest.approx(0.45),
        "step_glue_host_ms.train": pytest.approx(2.95), "launches_per_step.train": 5.0,
        "records_roofline.train": pytest.approx(
            100.0 * (8 * 1000 + 16 * 3000 + 24 * 1000 + 36 * 3000 + 40 * 1000)
            / rl.PEAK_BYTES / 250e-6)}


def test_frames_are_roots_unless_inside_a_step():
    ev = [x(trace.WINDOW, 0, 1000),
          x("gs.frame", 10, 200), x("gs.table", 20, 50), x("gs.composite", 100, 60),
          x("gs.frame", 300, 200), x("gs.table", 310, 40), x("gs.scan", 360, 10),
          x("cudaLaunchKernel", 25, 2, "cuda_runtime", corr=1),
          x("cudaLaunchKernel", 150, 2, "cuda_runtime", corr=2),      # glue
          x("k1", 40, 30, "kernel", tid=7, corr=1), x("k2", 160, 20, "kernel", tid=7, corr=2),
          x("gs.frame", 900, 200)]                                   # past the window
    sp = spans.reduce_spans(ev)
    assert (sp["root"], sp["roots"]) == ("gs.frame", 2)
    got = spans.values(sp, [dict(splats=10, records=20)] * 2)
    assert got["table_host_ms.render"] == pytest.approx(0.045)
    assert got["frame_glue_host_ms.render"] == pytest.approx(0.5 * (200 - 110 + 200 - 50) * 1e-3)
    assert got["launches_per_frame.render"] == 1.0
    # scan and expansion launched nothing: no records roofline
    assert "records_roofline.render" not in got and "sort_host_ms.render" in got
    inner = spans.reduce_spans(ev + [x("gs.step", 5, 800)])
    assert (inner["root"], inner["roots"]) == ("gs.step", 1)


def test_a_window_without_spans_gives_no_values():
    sp = spans.reduce_spans([x(trace.WINDOW, 0, 100), x("aten::add", 10, 5, "cpu_op")])
    assert sp["roots"] == 0 and spans.values(sp, []) == {}
    with pytest.raises(ValueError):
        spans.reduce_spans([x("gs.frame", 0, 10)])


@pytest.mark.parametrize("cell, root", [("tiny-bikebig-view", "gs.frame"),
                                        ("tiny-bicycle-train", "gs.step")])
def test_a_tiny_traced_cell_prints_its_spans(tiny, cell, root, capsys):
    capsys.readouterr()
    res, compared = run_tiny(tiny, cell, trace=1)
    assert res["correct"] is True, compared
    out = [line for line in capsys.readouterr().err.splitlines()
           if line.startswith(("span: ", "spans: "))]
    (roots,) = [line.split() for line in out if line.startswith("span: roots ")]
    assert roots[2:4] == ["2", root + ","]
    mean, stage, glue = (float(roots[i]) for i in (5, 9, 12))   # mean = stages + glue
    assert stage + glue == pytest.approx(mean)
    stages = {line.split()[1] for line in out if line.startswith("span: gs.")}
    assert {"gs.table", "gs.scan", "gs.expand", "gs.sort", "gs.composite"} <= stages
    vals = json.loads(out[-1][len("spans: "):])
    suffix = spans.SUFFIX[root]
    assert set(spans.GROUPS[root]) <= set(vals)
    assert all(k.endswith("." + suffix) for k in vals)
    assert all(v >= 0.0 for v in vals.values())
