"""The communication model of the port's distributed solvers
(``openmg_tpu_torch/parallel/model.py``) against what the ranks counted.

Every scalar solve of the two spawns (``tests/_torch_dist_cases.py``: the
stencil engine's V, W, F, 2D and PCG(2) on a (2, 2) mesh, and every sparse
case) records its rank-0 ``Comm.stats`` and the model of the same solver.
From a zero guess a solve of ``c`` cycles sends ``c`` times the model's
halo bytes a cycle and gathers ``c`` times its gathered bytes plus the
solution's delivery: equal bit for bit.  Beside that, the JAX package's
structural checks (``tests/test_parallel.py::test_comm_model_accounting``):
bounds in (0, 1], overlap at least no overlap, no halo traffic on the
coarsest level, and K1h's visits recognised on the stencil's fine level;
and the 3D fine level's halo above the pentadiagonal one's.
"""

import numpy as np
import pytest

from _torch_dist_cases import CASES, SPARSE_CASES, results
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

SCALAR = [n for n in CASES] + ["v2d"] + list(SPARSE_CASES)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return results(tmp_path_factory)


@pytest.mark.parametrize("name", SCALAR)
def test_model_bytes_equal_comm_stats(port, name):
    c = int(port[f"{name}/cycles"])
    m = {k.split("/", 2)[2]: v for k, v in port.items() if k.startswith(f"{name}/model/")}
    assert c > 0
    assert int(port[f"{name}/bytes_sent"]) == c * m["halo_bytes_per_cycle"]
    assert int(port[f"{name}/staged_bytes"]) == c * m["staged_bytes_per_cycle"] == 0
    assert int(port[f"{name}/gathered_bytes"]) == (
        c * m["gathered_bytes_per_cycle"] + m["delivery_gathered_bytes"])


@pytest.mark.parametrize("name", SCALAR)
def test_model_structure(port, name):
    m = lambda k: port[f"{name}/model/{k}"]  # noqa: E731
    assert m("hbm_bytes_per_cycle") > 0
    assert 0 < m("efficiency_bound_no_overlap") <= 1
    assert 0 < m("efficiency_bound_overlap") <= 1
    assert m("efficiency_bound_overlap") >= m("efficiency_bound_no_overlap")
    levels = m("level_halo_bytes")
    assert levels[-1] == 0.0
    assert levels.sum() <= m("halo_bytes_per_cycle")
    if not name.startswith("sp_irregular"):
        assert levels[0] > 0
    # the JAX package's keys (openmg_tpu/parallel/model.py)
    assert {"per_level", "halo_bytes_per_cycle", "hbm_bytes_per_cycle",
            "comm_fraction_no_overlap", "efficiency_bound_overlap",
            "efficiency_bound_no_overlap", "assumed_hbm_bytes_per_s",
            "assumed_ici_bytes_per_s"} <= set(m("keys"))


def test_fused_fine_level_recognised(port):
    """The stencil V solve's fine slab takes K1h for both visits."""
    assert bool(port["v/model/deep_fused"][0])
    assert not bool(port["v/model/deep_fused"][-1])


def test_3d_fine_level_halo_exceeds_pentadiagonal(port):
    assert port["v/model/level_halo_bytes"][0] > port["sp_jacobi/model/level_halo_bytes"][0]
    assert np.isfinite(port["v/model/comm_fraction_no_overlap"])
