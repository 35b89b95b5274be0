"""The port's command line (``python -m openmg_tpu_torch``) against the JAX
package's: the same flags, the same report keys (observe.solve_report);
the default device is the card, never the CPU by itself; ``--devices N``
starts N local ranks (gloo on the CPU here) and reports the partition."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from openmg_tpu import cli as jcli
from openmg_tpu_torch import cli as tcli
from openmg_tpu_torch.utils import observe as tobs
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARGS = ["--shape", "8", "8", "16", "--smoother", "jacobi", "--transfer", "linear",
        "--gridlevels", "2"]


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    jcli.main(ARGS + ["--report", str(d / "ref.json")])
    tcli.main(ARGS + ["--device", "cpu", "--levels", "--report", str(d / "port.json")])
    return (json.loads((d / "ref.json").read_text()),
            json.loads((d / "port.json").read_text()))


def test_report_keys_equal_reference(reports):
    ref, port = reports
    assert sorted(port) == sorted(set(ref) | {"levels"})
    assert port["config"] == ref["config"]
    assert port["level_stats"] == ref["level_stats"]
    assert port["cycles"] == ref["cycles"] and port["converged"]
    assert port["backend"] == ref["backend"] == "cpu"
    assert [sorted(r) for r in port["levels"]] == [
        ["constant", "level", "nnz", "shape", "smoother_ms_per_sweep",
         "smoother_nnz_per_s"]] * 2


def test_parsers_take_the_same_flags():
    def flags(p):
        return {s for a in p._actions for s in a.option_strings}

    assert flags(tcli.build_parser()) == flags(jcli.build_parser()) - {"--backend"} | {"--device"}


def test_default_device_is_the_card():
    """Without ``--device cpu`` the CLI runs on CUDA, and raises where
    there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(ARGS)


def test_distributed_cli_spawns_ranks(tmp_path):
    out = tmp_path / "dist.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    subprocess.run(
        [sys.executable, "-m", "openmg_tpu_torch", "--shape", "32", "8", "16",
         "--transfer", "linear", "--gridlevels", "3", "--devices", "2",
         "--device", "cpu", "--report", str(out)],
        check=True, env=env, cwd=tmp_path, timeout=120,
    )
    rep = json.loads(out.read_text())
    assert rep["n_devices"] == 2 and rep["partition_plan"] == [True, True, False]
    assert rep["converged"] and rep["cycles"] == 7


def test_pack_unpack_solve_meta():
    import torch

    packed = tobs.pack_solve_meta(3, torch.tensor([1.0, 0.5, 0.25, -1.0]), True)
    assert tobs.unpack_solve_meta(packed) == (3, [1.0, 0.5, 0.25], True)


def test_trace_writes_a_profile(tmp_path):
    import torch

    with tobs.trace(tmp_path / "prof"):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").exists()
