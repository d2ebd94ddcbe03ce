"""BENCHMARK.json against the rules of its format, and every name it
holds found as a file of its own."""

from __future__ import annotations

import json
import re

from conftest import BENCH, REPO

from benchmark import manifest

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_manifest_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(LINE.match(w) for w in MAN["command"]) and len(MAN["command"]) <= 32


def test_names_units_and_lines_use_allowed_characters():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert LINE.match(m["layer"])


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_each_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in MAN["workloads"]:
        e2e, layer = manifest.metrics_of(MAN, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert layer, w["name"]
        # a per-layer metric appears only in cells that report what it moves
        assert all(m["moves"] in names for m in layer), w["name"]


def test_per_layer_metrics_name_one_layer_and_one_moved_metric():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_is_found_as_a_file_of_its_own():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert manifest.config(c["name"])["name"] == c["name"]
    for w in MAN["workloads"]:
        kind = manifest.mix(w["traffic"])["kind"]
        assert kind in ("orbit", "train") or manifest.kind(kind).CELL, kind
        assert manifest.limits(w["name"]).get("limits"), w["name"]
    for m in MAN["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_command_names_only_files_under_paths():
    for word in MAN["command"][1:]:
        if "/" in word:
            assert word.startswith("benchmark/") and ".." not in word
            assert (REPO / word).is_file()
    for p in MAN["paths"]:
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    assert (BENCH / "run.py").is_file()
