"""The port's distributed stencil engine on gloo ranks (CPU processes)
against the JAX package's ``DistributedSolver`` on as many of the virtual
CPU devices ``tests/conftest.py`` provides, at the dry run's shape
``(max(32, 8·P), 8, 16)`` (three levels, the first two partitioned): the
V-cycle on two ranks, MG-PCG(2) on a (2, 2) mesh, and the V-cycle on a 2D
grid cut along y over two ranks (the port's ``(ny, 1, nx)`` slabs against
the reference's boundary-row epilogue).  The W and F cycles on two ranks
are held against the port's single-device W and F solves, which
``tests/test_torch_cycles.py`` holds against the JAX package's: each
reference W or F build costs more than the rest of this file's reference
solves together.

Equal cycle counts, residual histories within rtol 1e-3 (the norms are
sums in another order over other slabs, and the solutions differ at the
double-float floor), and ‖x_port − x_ref‖₂ ≤ 2e-10/λ_min (both below the
1e-10 threshold, so their difference is at most 2e-10/λ_min in exact
arithmetic).

Time: each mesh is ONE spawn of its ranks (``tests/_torch_dist_worker.py``,
which imports torch and the port only) running all its cases (the sparse
engine's and the model's too), through a file store (no port to collide on
between test workers), with a time limit on every wait, once a test session
(``tests/_torch_dist_cases.py``); the JAX package's solves run once, in a
module fixture, with its host loop (cheaper to compile than its device loop
at this size).
"""

import numpy as np
import pytest

from _torch_dist_cases import (
    CASES,
    CFG_2D,
    MANY,
    SHAPE_2D,
    assert_many_equals_scalars,
    assert_solves_agree as _agree,
    config_of,
    lam_min,
    many_seeds,
    results,
    shape_of,
)
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

# the cases held against the JAX package's DistributedSolver
REFERENCE = ("v", "pcg2_mesh2x2", "v2d")


def case_of(name):
    """``(shape, config, mesh)`` of a reference case."""
    if name == "v2d":
        return SHAPE_2D, CFG_2D, {"n_devices": 2}
    return shape_of(CASES[name][0]), config_of(name), CASES[name][2]


def assert_solves_agree(hist, x, want_hist, want_x, shape):
    _agree(hist, x, want_hist, np.asarray(want_x).reshape(shape), lam_min(shape))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return results(tmp_path_factory)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's solve of each reference case, and its ``v``
    solver (``v_solver``, for its ``solve_many``)."""
    from openmg_tpu import MeshConfig, SolverConfig
    from openmg_tpu.models.poisson import rhs_random
    from openmg_tpu.parallel.dist import distributed_setup

    out = {}
    for name in REFERENCE:
        shape, cfg, mesh = case_of(name)
        mc = (MeshConfig(mesh_shape=tuple(mesh["mesh_shape"])) if "mesh_shape" in mesh
              else MeshConfig(**mesh))
        solver = distributed_setup(shape, SolverConfig(**cfg, outer_loop="host"), mc)
        b = rhs_random(shape, seed=0)
        x, info = solver.solve(b / np.linalg.norm(b.ravel()))
        out[name] = (np.asarray(x), info)
        if name == "v":
            out["v_solver"] = solver
    return out


@pytest.mark.parametrize("name", REFERENCE)
def test_distributed_matches_reference(port, reference, name):
    jx, jinfo = reference[name]
    assert jinfo["converged"]
    assert int(port[f"{name}/cycles"]) == jinfo["cycles"]
    assert tuple(port[f"{name}/plan"]) == tuple(jinfo["partition_plan"]) == (True, True, False)
    assert_solves_agree(port[f"{name}/hist"], port[f"{name}/x"],
                        jinfo["residual_norms"], jx, case_of(name)[0])


@pytest.mark.parametrize("name", ["w", "f"])
def test_distributed_w_f_match_single_device(port, name):
    """W and F on two ranks: the port's single-device solve's cycles,
    history and solution (that solve is the reference's in
    ``tests/test_torch_cycles.py``)."""
    import openmg_tpu_torch as tmg

    shape = shape_of(CASES[name][0])
    solver = tmg.setup(shape, tmg.SolverConfig(**config_of(name)), device="cpu")
    b = tmg.rhs_random(shape, seed=0)
    x, info = solver.solve(b / np.linalg.norm(b.ravel()))
    assert info["converged"]
    assert int(port[f"{name}/cycles"]) == info["cycles"]
    assert tuple(port[f"{name}/plan"]) == (True, True, False)
    assert_solves_agree(port[f"{name}/hist"], port[f"{name}/x"],
                        info["residual_norms"], x, shape)


def test_ranks_exchange_halos_and_import_no_jax(port):
    assert int(port["v/exchanges"]) > 0
    assert list(port["jax_modules"]) == []


def test_distributed_resume_equals_uncut(port):
    """Cut after 3 cycles with a checkpoint (gathered and written by the
    first rank), resumed on every rank: the uncut solve's cycles and x."""
    assert int(port["v_resumed/cut_cycles"]) == 3
    assert int(port["v_resumed/cycles"]) == int(port["v/cycles"])
    np.testing.assert_array_equal(port["v_resumed/x"], port["v/x"])


def test_partition_plan_and_device_rule():
    """The plan is the reference's; ``distributed_setup`` never picks the
    CPU by itself."""
    import torch

    from openmg_tpu.parallel.dist import partition_plan as jplan
    from openmg_tpu_torch.parallel.dist import distributed_setup, partition_plan

    for shapes, n, mr, force in [
        ([(32, 8, 16), (16, 4, 8), (8, 2, 4)], 2, 2, False),
        ([(64, 8, 8), (32, 4, 4), (16, 2, 2), (8, 1, 1)], 4, 2, False),
        ([(64, 8, 8), (32, 4, 4), (16, 2, 2)], 8, 4, False),
        ([(16, 8, 8), (8, 4, 4)], 1, 2, True),
        ([(16, 8, 8), (8, 4, 4)], 1, 2, False),
        ([(24, 8, 8), (12, 4, 4), (6, 2, 2)], 4, 2, False),
    ]:
        assert partition_plan(shapes, n, mr, force) == jplan(shapes, n, mr, force)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed_setup((32, 8, 16))


def test_2d_slabs_match_single_device(port):
    """A 2D grid partitioned along y (K3h on ``(ny, 1, nx)`` slabs, the
    tensor double-float residual) takes the single-device solve's cycles
    and solution."""
    import openmg_tpu_torch as tmg

    solver = tmg.setup(SHAPE_2D, tmg.SolverConfig(**CFG_2D), device="cpu")
    b = tmg.rhs_random(SHAPE_2D, seed=0)
    x, info = solver.solve(b / np.linalg.norm(b))
    assert int(port["v2d/cycles"]) == info["cycles"]
    assert tuple(port["v2d/plan"]) == (True, True, False)
    assert np.linalg.norm((port["v2d/x"] - x).ravel()) <= 2e-10 / lam_min(SHAPE_2D)


@pytest.mark.parametrize("name,native_x0", [(n, False) for n in MANY] + [("v", True)])
def test_solve_many_members_equal_scalar_solves(port, name, native_x0):
    """``solve_many`` as one stack (one exchange of every member's planes a
    scalar exchange, one reduction and one host read of the members' norms
    a step): every member is bit-equal to the scalar solve of its
    right-hand side on the same ranks, and the bytes moved are the
    members' sums.  ``native_x0``: a float32 tensor batch from host
    initial guesses, against the scalar solves of the same inputs."""
    many = assert_many_equals_scalars(port, name, native_x0)
    shape = SHAPE_2D if name == "v2d" else shape_of(CASES[name][0])
    assert port[f"{many}/x"].shape == (3,) + tuple(shape)
    assert tuple(port[f"{many}/plan"]) == (True, True, False)
    if not native_x0:
        np.testing.assert_array_equal(port[f"{many}/x"][0], port[f"{name}/x"])


def test_solve_many_matches_reference(port, reference):
    """The V batch against the JAX package's ``DistributedSolver.
    solve_many`` (its device loop under ``vmap``) on the module's ``v``
    build: each member's cycles, and ‖x_port − x_ref‖₂ ≤ 2e-10/λ_min."""
    from openmg_tpu.models.poisson import rhs_random

    shape = shape_of(2)
    bs = []
    for sd in many_seeds({}):
        b = rhs_random(shape, seed=sd)
        bs.append(b / np.linalg.norm(b.ravel()))
    xs, info = reference["v_solver"].solve_many(np.stack(bs))
    assert all(info["converged"])
    assert list(port["v_many/cycles"]) == list(info["cycles"])
    for m in range(len(bs)):
        diff = np.linalg.norm((port["v_many/x"][m] - np.asarray(xs[m])).ravel())
        assert diff <= 2e-10 / lam_min(shape), m
