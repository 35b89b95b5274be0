"""The benchmark's specification and the files it names.

``BENCHMARK.json`` sits at the root of the checkout; every other file is
found by a name in it: a configuration by its ``file``, a traffic mix by
``omgbench/traffic/<traffic>.json``, a metric's reader by
``omgbench/metrics/<name>.py``, a problem kind's inputs and reference by
``omgbench/problems/<kind>.py`` and ``omgbench/reference/<kind>.py``.  A
root other than the checkout's may be given (the tests run copies).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "omgbench"


def load(root=ROOT) -> dict:
    """``BENCHMARK.json`` of ``root``."""
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, cell_entry: dict, root=ROOT) -> dict:
    """The configuration file of a cell, with its ``name``."""
    for c in bench["configs"]:
        if c["name"] == cell_entry["config"]:
            cfg = json.loads((Path(root) / c["file"]).read_text())
            return {**cfg, "name": c["name"]}
    raise KeyError(f"no configuration {cell_entry['config']!r} in BENCHMARK.json")


def traffic(name: str, root=ROOT) -> dict:
    path = Path(root) / PACKAGE / "traffic" / f"{name}.json"
    return {**json.loads(path.read_text()), "name": name}


def metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    without ``--trace``, the per-layer ones with it; a metric with a
    ``workloads`` key only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def module(kind: str, name: str, root=ROOT):
    """The module ``omgbench/<kind>/<name>.py`` of ``root``, loaded from
    its path (a name may hold dots and dashes)."""
    path = Path(root) / PACKAGE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} (the {kind} file of {name!r})")
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_{kind}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
