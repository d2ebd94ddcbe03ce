"""The port's streamed-viewer fps bench (``scripts/torch_viewer_fps_bench.py``)
in-process on the CPU at 2,000 splats and 3 frames: it delivers every frame
and prints one JSON line with the JAX script's keys (``scripts/
viewer_fps_bench.py``), plus the encoder and the device."""

import importlib.util
import json
from pathlib import Path

import pytest

from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
JAX_KEYS = {"splats", "res", "frames_delivered", "stream_fps", "render_only_ms",
            "render_only_fps", "records", "capacity"}


def _bench():
    spec = importlib.util.spec_from_file_location(
        "torch_viewer_fps_bench", REPO / "scripts" / "torch_viewer_fps_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_json_line_on_the_cpu(capsys):
    out = _bench().main(["--device", "cpu", "--splats", "2000", "--width", "64",
                         "--height", "64", "--frames", "3"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert JAX_KEYS | {"encoder", "device"} == set(out)
    assert out["splats"] == 2000 and out["res"] == "64x64"
    assert out["frames_delivered"] == 3
    assert out["stream_fps"] > 0 and out["render_only_ms"] > 0
    assert out["render_only_fps"] == pytest.approx(1e3 / out["render_only_ms"])
    assert out["records"] > 0 and out["capacity"] >= out["records"]
    assert out["device"] == "cpu" and out["encoder"] in ("PIL JPEG", "encode_png")


def test_bench_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _bench().main(["--splats", "10", "--frames", "1"])
