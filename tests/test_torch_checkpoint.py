"""Checkpoint/resume of the port's solve against the JAX package's.

The file format and the configuration hash are the same, so a checkpoint
written by either package resumes in the other; a solve cut after k cycles
and resumed ends with the uncut solve's cycle count and solution.  The
reference solve is a Jacobi V(1,1) cycle on (8, 8, 16) (nx = 16: the JAX
package's array path, no Pallas trace).
"""

import dataclasses

import numpy as np
import pytest

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.utils import checkpoint as jck
from openmg_tpu_torch.utils import checkpoint as tck
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

SHAPE = (8, 8, 16)
KW = dict(smoother="jacobi", pre_iterations=1, post_iterations=1, transfer="linear",
          residual_dtype="doublefloat", gridlevels=2, max_dense_coarse=2048)


def _b():
    b = tmg.rhs_random(SHAPE, seed=3)
    return b / np.linalg.norm(b)


@pytest.mark.parametrize("kw", [
    {}, {"smoother": "rbgs", "transfer": "aggregate"}, {"krylov": "pcg"},
    {"cycle_type": "w", "omega": 0.8},
])
@pytest.mark.parametrize("shape", [(8, 8, 16), (64, 64)])
def test_config_hash_equals_reference(kw, shape):
    cj = jmg.SolverConfig(**{**KW, **kw})
    ct = tmg.SolverConfig(**{**KW, **kw})
    assert ct.to_json() == cj.to_json()
    assert tck.config_hash(ct, shape) == jck.config_hash(cj, shape)
    # the stopping criteria do not enter the hash
    assert tck.config_hash(dataclasses.replace(ct, cycles=3, threshold=1e-3), shape) \
        == tck.config_hash(ct, shape)


@pytest.fixture(scope="module")
def uncut():
    solver = tmg.setup(SHAPE, tmg.SolverConfig(**KW), device="cpu")
    x, info = solver.solve(_b())
    assert info["converged"] and info["cycles"] > 4
    return solver, x, info


def test_cut_and_resumed_solve_equals_uncut(uncut, tmp_path):
    solver, x, info = uncut
    path = tmp_path / "ck.npz"
    cut = tmg.setup(SHAPE, tmg.SolverConfig(**dict(KW, cycles=3)), device="cpu")
    _, ci = cut.solve(_b(), checkpoint_path=path, checkpoint_every=1)
    assert ci["cycles"] == 3 and not ci["converged"]
    # every write costs one read of the iterate to the host
    assert ci["host_reads"] == 4 + 3
    xr, ri = solver.solve(_b(), checkpoint_path=path, resume=True)
    assert ri["cycles"] == info["cycles"]
    assert ri["residual_norms"][:4] == ci["residual_norms"]
    np.testing.assert_array_equal(xr, x)
    # the last write is the converged iterate
    x_ck, cyc, hist = tck.load_checkpoint(path, tck.config_hash(solver.config, SHAPE))
    assert cyc == info["cycles"] and len(hist) == cyc
    np.testing.assert_array_equal(x_ck.reshape(SHAPE), x)


def test_checkpoint_every_and_refusal(uncut, tmp_path):
    solver, x, info = uncut
    path = tmp_path / "ck.npz"
    _, ci = solver.solve(_b(), checkpoint_path=path, checkpoint_every=2)
    _, cyc, _ = tck.load_checkpoint(path, tck.config_hash(solver.config, SHAPE))
    assert cyc == info["cycles"] // 2 * 2
    other = tmg.setup(SHAPE, tmg.SolverConfig(**dict(KW, smoother="rbgs")), device="cpu")
    with pytest.raises(ValueError, match="refusing to resume"):
        other.solve(_b(), checkpoint_path=path, resume=True)
    with pytest.raises(ValueError, match="checkpoint_every"):
        solver.solve(_b(), checkpoint_path=path, checkpoint_every=0)


@pytest.fixture(scope="module")
def reference():
    cfg = jmg.SolverConfig(**KW)
    solver = jmg.setup(SHAPE, cfg)
    x, info = solver.solve(_b())
    return solver, np.asarray(x), info


def test_reference_checkpoint_resumes_in_port(reference, uncut, tmp_path):
    jsolver, jx, jinfo = reference
    path = tmp_path / "ref.npz"
    jcut = jmg.setup(SHAPE, jmg.SolverConfig(**dict(KW, cycles=2)))
    jcut.solve(_b(), checkpoint_path=str(path))
    tsolver, tx, tinfo = uncut
    xr, ri = tsolver.solve(_b(), checkpoint_path=path, resume=True)
    assert ri["converged"] and ri["cycles"] == jinfo["cycles"] == tinfo["cycles"]
    lam_min = sum(2 - 2 * np.cos(np.pi / (n + 1)) for n in SHAPE)
    assert np.linalg.norm((xr - jx).ravel()) <= 2e-10 / lam_min


def test_port_checkpoint_resumes_in_reference(reference, tmp_path):
    jsolver, jx, jinfo = reference
    path = tmp_path / "port.npz"
    tcut = tmg.setup(SHAPE, tmg.SolverConfig(**dict(KW, cycles=2)), device="cpu")
    tcut.solve(_b(), checkpoint_path=path)
    xr, ri = jsolver.solve(_b(), checkpoint_path=str(path), resume=True)
    assert ri["converged"] and ri["cycles"] == jinfo["cycles"]
    lam_min = sum(2 - 2 * np.cos(np.pi / (n + 1)) for n in SHAPE)
    assert np.linalg.norm((np.asarray(xr) - jx).ravel()) <= 2e-10 / lam_min
