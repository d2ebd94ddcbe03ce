"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each is a file of its
own, ``configs/<config>.json`` and ``traffic/<mix>.json``; a per-layer
metric is a reader ``metrics/<metric>.py``; a cell's limits for the
comparison that decides ``correct`` are ``limits/<cell>.json``. A mix's
``kind`` other than the two of ``run.py`` is ``kinds/<kind>.py``; a
configuration's scene generator other than the clustered one of
``scenes.py`` is ``generators/<name>.py``. Adding any of them adds files
and manifest entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import List, Tuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(base: Path, sub: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    with open(base / sub / f"{name}.json") as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the manifest")


def config(name: str, base: Path = HERE) -> dict:
    return _json(base, "configs", name)


def mix(name: str, base: Path = HERE) -> dict:
    return _json(base, "traffic", name)


def limits(cell: str, base: Path = HERE) -> dict:
    """The cell's limits, or {} where it has none yet."""
    try:
        return _json(base, "limits", cell)
    except FileNotFoundError:
        return {}


def _module(base: Path, sub: str, name: str, prefix: str):
    """The module of ``<base>/<sub>/<name>.py``, loaded once more at each
    call and registered under ``<prefix><name>``."""
    if not NAME.match(name):
        raise ValueError(f"bad {sub} name {name!r}")
    path = base / sub / f"{name}.py"
    mod_name = prefix + re.sub(r"[.-]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: Path = HERE):
    """The module of ``metrics/<name>.py``: ``read(records)`` returns the
    metric or None, ``KERNELS`` names the kernels of its stage (may be
    empty)."""
    return _module(base, "metrics", name, "bench_metric_")


def kind(name: str, base: Path = HERE):
    """The module of ``kinds/<name>.py``: ``CELL`` is its Cell class
    (``benchmark.cell`` says what it holds)."""
    return _module(base, "kinds", name, "bench_kind_")


def generator(name: str, base: Path = HERE):
    """The module of ``generators/<name>.py``: ``raw_scene(cfg, device)``
    makes the configuration's splats in raw form from its
    ``scene.structure_seed``, in a fixed order."""
    return _module(base, "generators", name, "bench_generator_")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(man: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The cell's end-to-end metrics and its per-layer metrics. A metric
    with ``workloads`` applies to those cells; a per-layer metric without
    it applies to every cell that reports the metric it moves."""
    e2e = [m for m in man["end_to_end"] if _applies(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer
