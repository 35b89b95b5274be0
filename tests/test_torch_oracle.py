"""The numpy oracle and the float64 / 1D paths on the CPU: the port's copy of
the original algorithm (``openmg_tpu_torch/utils/oracle.py``) against the
JAX package's, bit for bit (both are numpy); the 1D float64 trajectory of
the solver against that oracle; BASELINE config 1 and a float64 3D solve
against the JAX package's cycle counts.

The JAX package's 1D and float64 solves run array code (no Pallas trace).
"""

import numpy as np
import pytest

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.utils import oracle as jor
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.utils import oracle as tor
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

PARAMS = {"problemshape": (16, 16), "gridlevels": 3, "iterations": 2,
          "post_iterations": 1, "cycles": 30, "threshold": 1e-10}


@pytest.mark.parametrize("shape,levels", [((64,), 4), ((16, 16), 3), ((8, 8, 8), 3)])
def test_restrictions_and_coarsening_bit_equal(shape, levels):
    Rs_t, shapes_t = tor.restrictions(shape, levels)
    Rs_j, shapes_j = jor.restrictions(shape, levels)
    assert shapes_t == shapes_j
    A = tpoisson.poisson(shape)
    for Rt, Rj in zip(Rs_t, Rs_j):
        assert (Rt != Rj).nnz == 0 and Rt.dtype == Rj.dtype
    for At, Aj in zip(tor.coarsen_A(A, Rs_t), jor.coarsen_A(A, Rs_j)):
        np.testing.assert_array_equal(At.toarray(), Aj.toarray())


@pytest.mark.parametrize("smoother", ["gauss_seidel", "jacobi"])
def test_v_cycle_bit_equal(smoother):
    shape = (16, 16)
    A = tpoisson.poisson(shape)
    Rs, _ = tor.restrictions(shape, 3)
    As = tor.coarsen_A(A, Rs)
    b = tpoisson.rhs_random(shape, seed=2).ravel()
    x0 = tpoisson.rhs_random(shape, seed=3).ravel()
    got = tor.v_cycle_np(As, Rs, b, x0, 0, 2, 1, smoother)
    want = jor.v_cycle_np(As, Rs, b, x0, 0, 2, 1, smoother)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tor.jacobi_np(A, b, x0, 3), jor.jacobi_np(A, b, x0, 3))
    np.testing.assert_array_equal(
        tor.gauss_seidel_np(A, b, x0, 2), jor.gauss_seidel_np(A, b, x0, 2))


@pytest.mark.parametrize("smoother", ["gauss_seidel", "jacobi"])
def test_reference_mg_solve_equal(smoother):
    A = tpoisson.poisson(PARAMS["problemshape"])
    b = tpoisson.rhs_random(PARAMS["problemshape"], seed=4).ravel()
    p = {**PARAMS, "smoother": smoother}
    xt, it = tor.reference_mg_solve(A, b, p)
    xj, ij = jor.reference_mg_solve(A, b, p)
    assert it["cycles"] == ij["cycles"] and it["converged"] == ij["converged"]
    assert it["residual_norms"] == ij["residual_norms"]
    np.testing.assert_array_equal(xt, xj)


def test_trajectory_matches_oracle_jacobi_float64():
    """The solver's 1D float64 trajectory equals the oracle's, cycle for
    cycle (the JAX package's tests/test_solver.py, on the port)."""
    shape = (64,)
    b = tpoisson.rhs_random(shape, seed=1)
    cfg = tmg.SolverConfig(
        gridlevels=3, smoother="jacobi", pre_iterations=2, post_iterations=1,
        cycles=40, threshold=1e-9, dtype="float64", residual_dtype="float64",
        max_dense_coarse=64,
    )
    x, info = tmg.solve(shape, b, cfg, device="cpu")
    assert info["residual_mode"] == "float64" and x.dtype == np.float64
    _, info_ref = tor.reference_mg_solve(
        tpoisson.poisson(shape), b.ravel(),
        {"problemshape": shape, "gridlevels": 3, "iterations": 2,
         "post_iterations": 1, "cycles": 40, "threshold": 1e-9,
         "smoother": "jacobi"},
    )
    assert info["cycles"] == info_ref["cycles"]
    n = min(len(info["residual_norms"]), len(info_ref["residual_norms"]))
    np.testing.assert_allclose(
        info["residual_norms"][:n], info_ref["residual_norms"][:n], rtol=1e-6
    )


def test_baseline_config_1_takes_the_reference_cycles():
    """BASELINE config 1: 1D Poisson N=64, two levels, weighted Jacobi
    V(2,2), double-float outer residual."""
    shape = (64,)
    kw = dict(gridlevels=2, smoother="jacobi", pre_iterations=2,
              post_iterations=2, cycles=400, max_dense_coarse=64,
              residual_dtype="doublefloat")
    b = tpoisson.rhs_random(shape, seed=0)
    _, ij = jmg.solve(shape, b, jmg.SolverConfig(**kw))
    xt, it = tmg.solve(shape, b, tmg.SolverConfig(**kw), device="cpu")
    assert it["converged"] and ij["converged"]
    assert it["cycles"] == ij["cycles"] == 36
    assert np.linalg.norm(b - tpoisson.poisson(shape) @ xt) < 1e-10 * 1.05


def test_float64_3d_solve_takes_the_reference_cycles():
    shape = (8, 8, 8)
    kw = dict(gridlevels=2, max_dense_coarse=64, dtype="float64")
    b = tpoisson.rhs_random(shape, seed=6)
    _, ij = jmg.solve(shape, b, jmg.SolverConfig(**kw))
    xt, it = tmg.solve(shape, b, tmg.SolverConfig(**kw), device="cpu")
    assert it["converged"] and ij["converged"] and it["residual_mode"] == "float64"
    assert it["cycles"] == ij["cycles"]
    np.testing.assert_allclose(it["residual_norms"], ij["residual_norms"], rtol=1e-6)
