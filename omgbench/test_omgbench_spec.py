"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name; a configuration, a traffic mix and a metric added as
new files alone run."""

from __future__ import annotations

import hashlib
import json
import re

from omgbench import harness, spec
from omgbench.conftest import REPO, tiny_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    raw = (REPO / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == TOP_KEYS
    assert 1 <= len(b["command"]) <= 32 and all(line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51

    names = set()
    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(configs) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p.rstrip("/") + "/" for p in b["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in b["configs"]}) == len(configs)

    cells = {w["name"]: w for w in b["workloads"]}
    assert 1 <= len(cells) <= 24 and len(cells) == len(b["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    assert {w["config"] for w in b["workloads"]} == set(configs)

    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(b["per_layer"]) <= 128
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
    for name in cells:
        reported = [m["name"] for m in spec.metrics(b, name, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics(b, name, True)


def test_every_file_is_found_by_name():
    b = spec.load()
    for w in b["workloads"]:
        cfg = spec.config(b, w, REPO)
        assert spec.module("problems", cfg["problem"]).make
        ref = spec.module("reference", cfg["problem"])
        assert ref.prepare and ref.residual_norm
        t = spec.traffic(w["traffic"])
        assert t["call"] in harness.CALLS and t["pool"] % t["batch"] == 0
        assert cfg["check"]["residual_limit"] > 0
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.module("metrics", m["name"]).read)


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "omgbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_and_metric_run_as_new_files_alone(tiny_root):
    before = digests(tiny_root)
    d = tiny_root / "omgbench"
    cfg = json.loads((d / "configs" / "poisson3d-256.json").read_text())
    (d / "configs" / "poisson3d-box.json").write_text(json.dumps(cfg))
    tiny_config(d / "configs" / "poisson3d-box.json")
    (d / "traffic" / "pair.json").write_text(json.dumps({
        "call": "solve_many", "batch": 2, "pool": 4, "check_calls": 1,
        "trace_skip": 0, "trace_calls": 2, "why": "two right-hand sides a call"}))
    (d / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "poisson3d-box", "source": "a test", "reduced": [],
                         "file": "omgbench/configs/poisson3d-box.json", "why": "a test"})
    b["workloads"].append({"name": "poisson3d-box.pair", "config": "poisson3d-box",
                           "traffic": "pair", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                           "source": "host_clock", "layer": "test", "moves": "mdof_per_s",
                           "workloads": ["poisson3d-box.pair"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(b))
    assert {k: v for k, v in digests(tiny_root).items() if k in before} == before

    r, _ = harness.run_cell(spec.load(tiny_root), "poisson3d-box.pair", 11, 0.2, True,
                            "cpu", root=tiny_root)
    assert r["correct"] and r["metrics"]["calls_in_window"]["value"] >= 1
    assert r["attempted"] == 2 * r["metrics"]["calls_in_window"]["value"]
