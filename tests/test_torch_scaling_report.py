"""The port's scaling report (``scripts/torch_scaling_report.py``) on the
CPU at a small size: the report's counts against its own cross-check
(``render_fast_sharded`` on a CPU mesh exchanges exactly the binned
records, and the owners' records sum to them), the flagship table's rows,
no time on the CPU, and the per-tile record counts of its layout equal to
the JAX fast path's (``fastpath.render_fast(..., stop_after="sort2")``
bounds, Pallas in interpret mode) on the same scene, exactly.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openglgaussiansplattingrenderer_tpu.config import RenderConfig as JaxConfig
from openglgaussiansplattingrenderer_tpu.ops import fastpath as jfp
from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_PATH = Path(__file__).resolve().parents[1] / "scripts" / "torch_scaling_report.py"
_SPEC = importlib.util.spec_from_file_location("torch_scaling_report", _PATH)
sr = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(sr)

W, H = 128, 96
ARGV = ["--device", "cpu", "--splats", "2000", "--width", str(W), "--height", str(H),
        "--flagship-splats", "2000", "--json"]


@functools.lru_cache(maxsize=None)
def _report(devices):
    return sr.main(ARGV + ["--devices", str(devices)])


@pytest.mark.parametrize("devices", [2, 4])
def test_report_counts_hold_against_the_sharded_frame(devices, capsys):
    rep = _report(devices)
    sc = rep["scene"]
    assert rep["device"] == "cpu" and not rep["link"]["measured"]
    assert sc["devices"] == devices and len(sc["per_owner_records"]) == devices
    assert sum(sc["per_owner_records"]) == sc["binned_records"] > 0
    assert sc["cross_check"] == dict(sc["cross_check"], equal=True, overflow=0,
                                     exchanged_records=sc["binned_records"])
    assert 0.0 < sc["efficiency_bound"] <= 1.0
    assert sc["exchange_bytes"] == sc["binned_records"] * (1 - 1 / devices) * 44
    rows = rep["flagship"]["table"]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert len({r["binned_records"] for r in rows}) == 1
    assert rows[0]["efficiency_bound"] == 1.0 and rows[0]["exchange_bytes"] == 0.0
    assert all(r["bound_fps"] is None and r["measured_frame_ms"] is None for r in rows)
    assert rep["flagship"]["pr10_four_card_frame_ms"] == [51.91, 52.497, 54.154]


def test_layout_counts_equal_the_jax_fast_path():
    params, args, cfg = sr.frame_of(2000, 42, W, H, 128, 6.0, (-5.5, -3.2), "cpu")
    got = sr.tile_bounds(params, args, W, H, cfg)
    jcfg = JaxConfig.for_resolution(W, H, tile_px=32, use_pallas=True, chunk=128,
                                    dup_capacity_factor=6.0,
                                    capacity_records=cfg.capacity_records)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}

    @jax.jit
    def bounds(p, view, vp):
        return jfp.render_fast(p, view, vp, *args[2:], W, H, jcfg,
                               stop_after="sort2")[1]["bounds"]

    want = np.asarray(bounds(jp, jnp.asarray(args[0].numpy()), jnp.asarray(args[1].numpy())))
    np.testing.assert_array_equal(got, want)
    assert got[-1] > 0


def test_topo_link_reads_the_matrix_through_its_escapes(monkeypatch):
    """``nvidia-smi topo -m`` underlines its headers with terminal escapes,
    and its header row starts with GPU0 too: the link of a row's card to a
    column's is read past both; a card it does not list, or a failed
    command, reads "not read" and why."""
    out = ("\t\x1b[4mGPU0\tGPU1\tGPU2\tCPU Affinity\tNUMA Affinity\x1b[0m\n"
           "\x1b[4mGPU0\x1b[0m\t X \tNV18\tNV12\t0-7\t0\n"
           "\x1b[4mGPU1\x1b[0m\tNV18\t X \tNV18\t0-7\t0\n")

    class Done:
        stdout, stderr, returncode = out, "", 0

    monkeypatch.setattr(sr.subprocess, "run", lambda *a, **k: Done())
    assert [sr.topo_link(0, 1), sr.topo_link(0, 2), sr.topo_link(1, 0)] == [
        "NV18", "NV12", "NV18"]
    assert sr.topo_link(3, 0).startswith("not read")

    class Failed:
        stdout, stderr, returncode = "", "Failed to initialize NVML\n", 9

    monkeypatch.setattr(sr.subprocess, "run", lambda *a, **k: Failed())
    assert sr.topo_link(0, 1) == "not read (exit 9: Failed to initialize NVML)"
