"""Runs of the cells at 16³ on the CPU: the result line, the output check
with its control and with the timed path broken, and the command's
refusals."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import openmg_tpu_torch.core.solver as solver_mod
from omgbench import harness, run, spec
from omgbench.conftest import REPO

CELLS = ("poisson3d-256.single", "diffusion3d-256.single", "poisson3d-256.batch8")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def cell_run(root, name, trace=False, seed=2**31 + 5, **kw):
    return harness.run_cell(spec.load(root), name, seed, 0.3, trace, "cpu", root=root, **kw)[0]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct_with_the_keys_in_order(tiny_root, name, trace):
    r = cell_run(tiny_root, name, trace)
    assert list(r) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    b = spec.load(tiny_root)
    wanted = {m["name"] for m in spec.metrics(b, name, trace)}
    # off the card no device number is read: no peak, no trace metrics
    off_card = {"peak_mem_gb", "launches_per_step", "roofline_share", "idle_share"}
    assert set(r["metrics"]) == wanted - off_card
    assert r["checks"]["residual_max"]["value"] <= r["checks"]["residual_max"]["limit"]
    assert r["checks"]["unconverged"] == {"value": 0, "limit": 0}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(tiny_root, name):
    """The configuration's control (the program's float32 outer residual)
    cannot reach the stated accuracy: the reference reads it far above the
    limit."""
    r = cell_run(tiny_root, name, control=True)
    assert not r["correct"] and r["failed"] >= 1
    c = r["checks"]["residual_max"]
    assert c["value"] > 100 * c["limit"]


def test_a_step_that_returns_its_state_unchanged_fails(tiny_root, monkeypatch):
    monkeypatch.setattr(solver_mod.Solver, "_inner", lambda self, r: torch.zeros_like(r))
    r = cell_run(tiny_root, "poisson3d-256.single")
    assert not r["correct"] and r["checks"]["unconverged"]["value"] >= 1
    assert r["checks"]["residual_max"]["value"] > r["checks"]["residual_max"]["limit"]


def test_half_of_the_batch_left_out_fails(tiny_root, monkeypatch):
    """The first half of each batch solved, the rest returned as zeros with
    the first half's report."""
    own = solver_mod.Solver.solve_many

    def half(self, bs, x0s=None):
        k = bs.shape[0] // 2
        xs, info = own(self, bs[:k])
        pair = tuple(torch.cat([t, torch.zeros_like(t)]) for t in info["x_df"])
        info = {**info, "x_df": pair}
        for key in ("cycles", "converged", "final_norm"):
            info[key] = info[key] * 2
        return pair[0], info

    monkeypatch.setattr(solver_mod.Solver, "solve_many", half)
    r = cell_run(tiny_root, "poisson3d-256.batch8")
    assert not r["correct"] and r["checks"]["unconverged"]["value"] == 0
    assert r["checks"]["residual_max"]["value"] > r["checks"]["residual_max"]["limit"]


@pytest.mark.parametrize("name", ["poisson3d-256.single", "diffusion3d-256.single"])
def test_an_answer_altered_where_produced_fails(tiny_root, monkeypatch, name):
    own = solver_mod.Solver.solve

    def altered(self, b, x0=None, **kw):
        x, info = own(self, b, x0, **kw)
        hi, lo = info["x_df"]
        hi = hi.clone()
        hi.view(-1)[hi.numel() // 3] += 1e-6
        info = {**info, "x_df": (hi, lo)}
        return hi, info

    monkeypatch.setattr(solver_mod.Solver, "solve", altered)
    r = cell_run(tiny_root, name)
    assert not r["correct"] and r["checks"]["unconverged"]["value"] == 0
    assert r["checks"]["residual_max"]["value"] > r["checks"]["residual_max"]["limit"]


def test_the_command_refuses_to_run_without_a_card():
    p = subprocess.run(
        [sys.executable, "-m", "omgbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=120,
    )
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def fake_result():
    return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "checks": {"residual_max": {"value": 1e-11, "limit": 1e-10}}}


def test_the_command_prints_the_line_last_and_the_checks_on_stderr(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: (fake_result(), {"import_s": 1.0}))
    assert run.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == fake_result()
    assert err.strip().splitlines()[-2:] == ["set-up import_s 1.000",
                                             "check residual_max 1e-11 limit 1e-10"]


def test_the_command_prints_no_result_when_jax_is_loaded(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: (fake_result(), {"import_s": 1.0}))
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err


def test_too_few_cards_is_refused(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", CELLS[0], "--seed", "3", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_a_tiny_cell_on_the_card(card, tiny_root):
    r, _ = harness.run_cell(spec.load(tiny_root), CELLS[0], 9, 0.5, True, card, root=tiny_root)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and "launches_per_step" in r["metrics"]
