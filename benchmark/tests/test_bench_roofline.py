"""Counts kept with the benchmark, worked out by hand on small shapes; the
kernel attribution and the reduction of a profiler timeline."""

from __future__ import annotations

import pytest
from conftest import BENCH

from benchmark import manifest, roofline as rl, trace


def test_peaks_and_bounds():
    assert rl.bound_s(3.35e9) == pytest.approx(1e-3)
    assert rl.bound_s(0.0, 67e9) == pytest.approx(1e-3)
    assert rl.bound_s(3.35e9, 134e9) == pytest.approx(2e-3)


def test_stage_bytes_by_hand():
    assert rl.sh_rest_floats(0) == 0 and rl.sh_rest_floats(3) == 45
    assert rl.table(1000, 0) == (126_000, 0.0)
    assert rl.table(1000, 3) == (306_000, 0.0)          # + 45 floats read
    assert rl.table(1000, 0, backward=True) == (136_000, 0.0)
    assert rl.table(1000, 3, backward=True) == (496_000, 0.0)  # + read and written
    assert rl.sort(10) == (840.0, 0.0) and rl.sort(10, backward=True) == (760.0, 0.0)
    assert rl.composite(10, 4) == (36 * 10 + 16 * 4, 0.0)
    assert rl.composite(10, 4, backward=True) == (72 * 10 + 32 * 4, 0.0)
    assert rl.adam(100) == (2800.0, 0.0)
    assert rl.loss(10) == (240.0, 6600.0)
    assert rl.loss(10, backward=True) == (360.0, 3960.0)
    assert rl.expand(10, 2) == (16 * 10 + 24 * 2, 0.0)
    assert rl.segsum(10, 2) == (36 * 10 + 40 * 2, 0.0)


def shapes(**kw):
    s = dict(splats=1000, sh_degree=0, records=3000, binned=2500, pixels=4096,
             image_pixels=4000, adam_elements=14000)
    s.update(kw)
    return s


def test_frame_and_step_sums():
    s = shapes()
    frame = rl.frame_stages(s)
    assert set(frame) == {"table", "prefix", "expand", "sort", "composite", "image"}
    want = (126_000 + 8_000 + (16 * 3000 + 24 * 1000) + 84 * 3000 + (36 * 2500 + 16 * 4096)
            + 16 * (4096 + 4000)) / 3.35e12
    assert rl.bound_sum_s(frame) == pytest.approx(want)
    step = rl.step_stages(s)
    assert set(frame) < set(step) and "adam" in step and "loss_bwd" in step
    assert step["adam"] == (28 * 14000, 0.0)


def rec(kernels, units=(), window=1.0, busy=0.5):
    return trace.Records(kernels=kernels, window_s=window, busy_s=busy, units=list(units),
                         host_s=[])


def test_roofline_share_and_a_name_outside_every_map():
    ks = {"(anonymous namespace)::splat_table_fwd(float const*, int)": 2e-6,
          "(anonymous namespace)::splat_table_fwd_v2(float const*)": 5e-6,
          "(anonymous namespace)::expand_records(float const*)": 3e-6,
          "void at::native::elementwise_kernel<128, 4>(int)": 1e-6}
    r = rec(ks, [shapes(splats=26_587)])   # 126 B x 26,587 = 3.35e6 B: 1 us
    assert rl.stage_time_s(ks, ("splat_table_fwd",)) == pytest.approx(2e-6)
    assert rl.roofline_pct(r, ("splat_table_fwd",), [rl.table(26_587, 0)]) == \
        pytest.approx(100.0 * 126 * 26_587 / 3.35e12 / 2e-6)
    left = [k for k, _ in rl.unattributed(ks, [("splat_table_fwd",), ()])]
    assert left == ["(anonymous namespace)::splat_table_fwd_v2(float const*)",
                    "(anonymous namespace)::expand_records(float const*)",
                    "void at::native::elementwise_kernel<128, 4>(int)"]
    assert rl.roofline_pct(r, ("composite_fwd",), [rl.composite(1, 1)]) is None


def test_every_reader_returns_nothing_where_it_finds_nothing():
    empty = rec({}, [], window=0.0, busy=0.0)
    for path in sorted((BENCH / "metrics").glob("*.py")):
        assert manifest.reader(path.stem).read(empty) is None, path.stem


def test_mfu_and_idle_readers():
    r = rec({"x": 0.1}, [shapes(), shapes()], window=2e-3, busy=1.5e-3)
    want = 100.0 * 2 * rl.bound_sum_s(rl.frame_stages(shapes())) / 2e-3
    assert manifest.reader("frame_mfu_pct.render").read(r) == pytest.approx(want)
    assert manifest.reader("device_idle_pct.render").read(r) == pytest.approx(25.0)


def test_reduce_events_window_busy_and_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "gpu_user_annotation", "name": trace.WINDOW, "ts": 5, "dur": 9},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 250, "dur": 150},
          {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 600, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1500, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::outer", "ts": 380, "dur": 300},
          {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 450, "dur": 100},
          {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 3}]
    out = trace.reduce_events(ev)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(400e-6)
    assert out["kernels"] == {"k1": pytest.approx(200e-6), "k2": pytest.approx(150e-6)}
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::inner"] == pytest.approx(200e-6)       # the innermost at 500
    assert gaps["host: between operators"] == pytest.approx(400e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(200e-6)]
