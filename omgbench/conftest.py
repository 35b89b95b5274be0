"""Fixtures of the benchmark's own tests (``python -m pytest omgbench``).

``card``: tests marked ``card`` take it and skip without a CUDA device
(decided here, when the test runs, never at import).  ``tiny_root``: a copy
of the benchmark (``BENCHMARK.json`` and ``omgbench/``) whose two
configurations are cut to 16³ with a dense 4³ level, so that every cell
runs on the CPU in about a second, and traced runs trace two calls.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TINY = 16


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run on the card)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def tiny_config(path: Path) -> None:
    """Cut a configuration file to 16³ (levels 16³, 8³ and a dense 4³)."""
    c = json.loads(path.read_text())
    c["shape"] = [TINY] * 3
    c["solver"]["max_dense_coarse"] = (TINY // 4) ** 3
    c["levels"] = [dict(c["levels"][0], shape=[TINY] * 3),
                   dict(c["levels"][1], shape=[TINY // 2] * 3),
                   dict(c["levels"][-1], shape=[TINY // 4] * 3)]
    path.write_text(json.dumps(c, indent=1))


@pytest.fixture
def tiny_root(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "omgbench", tmp_path / "omgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in (tmp_path / "omgbench" / "configs").glob("*.json"):
        tiny_config(path)
    for path in (tmp_path / "omgbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        path.write_text(json.dumps(dict(t, trace_skip=1, trace_calls=2)))
    return tmp_path
