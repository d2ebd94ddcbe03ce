"""The port's benchmark scripts in-process on the CPU at a small size, and
what every new script shares:

- each prints its result as the last JSON line, equal to ``main``'s return
  value, with the JAX script's keys plus ``device`` and ``card``;
- each refuses CUDA without a card ("no CUDA device", exit 1), and none
  imports ``jax`` or the JAX package (an AST check of every
  ``scripts/torch_*.py``);
- ``torch_flagship_bench``: both scenes without overflow, the headline the
  worse scene's fps; q16 with a backward refused before any timing;
- ``torch_scale_test``: the native loader's means equal to the written
  scene's; finite gradients, no overflow;
- ``torch_baseline_eval`` config 1 on the built-in fixture within 1e-2 of
  the numpy golden (the reference's own tolerance);
- ``torch_radix_sort_bench`` at 4,096 and 10,000 keys: every ``*_exact``
  true (the plain versions here);
- ``torch_profile_stages`` with ``hoist_depth_sort`` True and False: every
  prefix runs, and the "sort2" bounds give the full frame's per-tile
  record counts (their total, largest and mean).
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401, E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
NEW_SCRIPTS = ("torch_train_bench", "torch_novel_view_bench", "torch_nv_holdout_eval",
               "torch_flagship_bench", "torch_scale_test", "torch_baseline_eval",
               "torch_radix_sort_bench", "torch_profile_stages")
PROFILE_KEYS = {"prefix_ms", "stage_ms", "composite_fwd_ms", "composite_fwdbwd_ms",
                "full_fwdbwd_ms", "bwd_stage_ms"}


@pytest.fixture(autouse=True)
def one_timed_call(monkeypatch):
    """Each of the scripts' timings takes one call here: the CPU's times are
    not what these tests hold."""
    from openglgaussiansplattingrenderer_tpu_torch.utils import timing

    real = timing.median_ms
    monkeypatch.setattr(timing, "median_ms",
                        lambda fn, device, iters=20, repeats=3: real(fn, device, 1, 1))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("path", sorted((REPO / "scripts").glob("torch_*.py")),
                         ids=lambda p: p.name)
def test_no_script_of_the_port_imports_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "openglgaussiansplattingrenderer_tpu",
                               "gsplat_tpu"), f"{path.name} imports {name}"


@pytest.mark.parametrize("name", NEW_SCRIPTS)
def test_scripts_refuse_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _script(name).main([])


def test_flagship_bench(capsys):
    argv = ["--device", "cpu", "--splats", "2000", "--width", "128", "--height", "64",
            "--iters", "1", "--bwd"]
    mod = _script("torch_flagship_bench")
    out = mod.main(argv)
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "device", "card"}
    scenes = {r["scene"]: r for r in lines[:-1]}
    assert set(scenes) == {"uniform", "clustered"}
    for r in scenes.values():
        assert set(r) == {"scene", "fwd_ms", "fps", "capacity", "records", "binned",
                          "max_bin", "mean_bin", "fwdbwd_ms", "device", "card"}
        assert r["records"] <= r["capacity"] and r["fwdbwd_ms"] > 0
    assert len({r["capacity"] for r in scenes.values()}) == 1
    assert out["metric"] == "fps_flagship_1024x512_fwd"
    assert out["value"] == min(r["fps"] for r in scenes.values())
    assert out["vs_baseline"] == pytest.approx(out["value"] / 30.0)
    with pytest.raises(SystemExit, match="q16"):
        mod.main(argv + ["--depth-key", "packed", "--sort-payload", "q16"])


def test_scale_test(capsys, tmp_path):
    mod = _script("torch_scale_test")
    ply = tmp_path / "scale.ply"
    args = mod.parse_args(["--device", "cpu", "--splats", "2000", "--width", "128",
                           "--height", "72", "--ply", str(ply)])
    out, extras = mod.run(args)
    assert set(out) == {"num_splats", "native_load_s", "fwd_ms", "fwdbwd_ms", "fwd_fps",
                        "overflow", "grads_finite", "device", "card"}
    assert out["num_splats"] == 2000 and out["overflow"] == 0 and out["grads_finite"]
    np.testing.assert_allclose(extras["loaded"]["means"], extras["written"]["means"],
                               atol=1e-6, rtol=0)
    # a second run reads the file as it is, through main
    again = mod.main(["--device", "cpu", "--splats", "2000", "--width", "128",
                      "--height", "72", "--ply", str(ply)])
    assert _last_json(capsys) == again and again["overflow"] == 0


def test_baseline_config1_against_the_golden(capsys):
    out = _script("torch_baseline_eval").main(["--device", "cpu", "--configs", "1"])
    assert _last_json(capsys) == out
    assert set(out) == {"config1", "device", "card"}
    c1 = out["config1"]
    assert c1["src"] == "built-in fixture"
    assert c1["max_abs_diff_vs_golden"] <= 1e-2 and c1["frame_ms"] > 0


def test_radix_sort_bench_exact(capsys):
    out = _script("torch_radix_sort_bench").main(["--device", "cpu", "--sizes",
                                                   "4096,10000"])
    assert _last_json(capsys) == out
    assert set(out) == {"radix_bench", "device", "card"}
    assert [r["C"] for r in out["radix_bench"]] == [4096, 10000]
    for r in out["radix_bench"]:
        assert set(r) == {"C", "lax_ms", "radix31_ms", "radix31_exact", "radix9_ms",
                          "radix9_exact"}
        assert r["radix31_exact"] is True and r["radix9_exact"] is True


@pytest.mark.parametrize("hoist", [False, True])
def test_profile_stages(hoist, capsys):
    mod = _script("torch_profile_stages")
    argv = ["--device", "cpu", "--splats", "1000", "--width", "96", "--height", "64",
            "--iters", "1", "--bwd-stages"] + (["--hoist"] if hoist else [])
    run, ran = mod.run, []
    mod.run = lambda args: ran.append(run(args)) or ran[0]
    printed = mod.main(argv)
    assert _last_json(capsys) == printed
    out, extras = ran[0]
    assert out == printed
    assert set(out) == PROFILE_KEYS | {"device", "card"}
    stages = ["prep"] + (["sort1"] if hoist else []) + ["cumsum", "expand", "sort2"]
    assert list(out["prefix_ms"]) == stages + ["full"]
    assert list(out["stage_ms"]) == stages + ["composite"]
    assert list(out["bwd_stage_ms"]) == ["prep", "expand", "sort2", "composite"]
    assert all(np.isfinite(v) and v > 0 for v in out["prefix_ms"].values())
    assert sum(out["stage_ms"].values()) == pytest.approx(out["prefix_ms"]["full"])
    _, bounds = extras["sort2"]
    per_tile = (bounds[1:] - bounds[:-1]).to(torch.float32)
    st = extras["full_stats"]
    assert int(bounds[-1]) == int(st["binned_records"]) > 0
    assert int(per_tile.max()) == int(st["max_bin"])
    assert float(per_tile.mean()) == pytest.approx(float(st["mean_bin"]))
    assert extras["cfg"].hoist_depth_sort is hoist
