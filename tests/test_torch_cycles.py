"""W and FMG cycles, MG-preconditioned CG and the batched ``solve_many`` of
the port on the CPU against the JAX package, on both engines.

Three stencil problems: 16³ Poisson from the grid shape (a constant
7-point fine level, cornered 27-point coarse levels), 32² Poisson (a
5-point fine level, cornered 9-point coarse levels) and 16³ diffusion from
a stencil pair (varying levels).  For each of ``w``, ``f`` and ``pcg`` the
reference runs its host outer loop (``outer_loop="host"``), whose jitted
inner solve (``solver._cycle``) is compiled once and serves both the
function-level comparison (one ``v_cycle(gamma=2)``, ``fmg_cycle`` or
``pcg_solve`` on the reference hierarchy carried across as numpy) and the
whole solve.  They run weighted-Jacobi V(1,1), whose reference programs
compile in about a third of the time of red/black V(2,2)'s (the red/black
smoother and V(2,2) are the card's main path, held there against their
plain versions).  Reference solves sit in a module-scoped cache.

``solve_many``: each member bit-equal to the port's own scalar solve, the
cycle counts equal to the reference's ``solve_many``.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu_torch.core import cycle as tcycle
from openmg_tpu_torch.utils.convert import hierarchy_from_numpy

from _torch_parity import assert_close, rand, spec_from_jax_hierarchy, to_j, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

OMEGA = 2.0 / 3.0

# name -> (grid shape, whether it is the diffusion problem, pre- and
# post-smoothing sweeps)
PROBLEMS = {
    "poisson3d": ((16, 16, 16), False, 1),
    "poisson2d": ((32, 32), False, 1),
    "diffusion3d": ((16, 16, 16), True, 1),
}
INNER = {
    "w": dict(cycle_type="w"),
    "f": dict(cycle_type="f"),
    "pcg": dict(krylov="pcg", krylov_iters=2),
}
CASES = [(p, c) for p in PROBLEMS for c in INNER]


def _kappa(shape):
    return 0.5 + np.random.default_rng(12).random(shape)


def _problem(pkg, name):
    shape, diffusion, _ = PROBLEMS[name]
    return pkg.diffusion_stencil(_kappa(shape)) if diffusion else shape


def _config(pkg, name, inner, **kw):
    sweeps = PROBLEMS[name][2]
    return pkg.SolverConfig(
        smoother="jacobi", transfer="linear", residual_dtype="doublefloat",
        gridlevels=3, max_dense_coarse=512, cycles=60,
        pre_iterations=sweeps, post_iterations=sweeps, **INNER[inner], **kw,
    )


def _rhs(shape, seed=1):
    b = np.random.default_rng(seed).standard_normal(shape)
    return b / np.linalg.norm(b)


def _matrix(name):
    shape, diffusion, _ = PROBLEMS[name]
    return tmg.diffusion(_kappa(shape)) if diffusion else tmg.poisson(shape)


def _lam_min(A):
    return float(spla.eigsh(A.tocsc(), k=1, sigma=0, which="LM",
                            return_eigenvectors=False)[0])


def _same_history(got, want):
    """Entry by entry within ×1.1, ×1.5 below 1e-9 (the double-float floor
    ‖A‖·‖x‖·2⁻⁴⁹, where the f32 cycles' last bits decide more)."""
    assert len(got) == len(want), (got, want)
    for k, (a, b) in enumerate(zip(got, want)):
        bound = 1.5 if b < 1e-9 else 1.1
        assert b / bound <= a <= b * bound, (k, a, b)


@pytest.fixture(scope="module")
def reference():
    """``get(problem, inner)`` -> the reference's (solver, x, info) of the
    problem's solve, set up and solved once."""
    cache = {}

    def get(name, inner):
        if (name, inner) not in cache:
            solver = jmg.setup(_problem(jmg, name),
                               _config(jmg, name, inner, outer_loop="host"))
            x, info = solver.solve(_rhs(PROBLEMS[name][0]))
            assert info["outer_loop"] == "host"
            cache[name, inner] = solver, np.asarray(x), info
        return cache[name, inner]

    return get


@pytest.mark.parametrize("name,inner", CASES)
def test_inner_solve_matches_reference(reference, name, inner):
    """One ``v_cycle(gamma=2)``, ``fmg_cycle`` or ``pcg_solve(iters=2)`` of
    each package on the same hierarchy and right-hand side, within
    1e-5·max|ref| (float32 cycles summed in another order)."""
    solver = reference(name, inner)[0]
    hj = solver.hierarchy
    ht = hierarchy_from_numpy(spec_from_jax_hierarchy(hj), "cpu")
    shape = PROBLEMS[name][0]
    sweeps = PROBLEMS[name][2]
    r = rand(shape, 5)
    want = solver._cycle(hj, to_j(r))
    args = (sweeps, sweeps, "jacobi", OMEGA)
    if inner == "w":
        got = tcycle.v_cycle(ht, to_t(r), None, 0, *args, gamma=2, x_zero=True)
    elif inner == "f":
        got = tcycle.fmg_cycle(ht, to_t(r), *args)
    else:
        got = tcycle.pcg_solve(ht, to_t(r), 2, "v", *args)
    assert_close(got, want, factor=1e-5, what=f"{name} {inner}")


@pytest.mark.parametrize("name,inner", CASES)
def test_solve_matches_reference(reference, name, inner):
    """The port's own setup and solve: the reference's cycle count, its
    history, and a solution within 2e-10/λ_min of the reference's (both
    are within the threshold of one exact solution)."""
    _, xr, ir = reference(name, inner)
    shape = PROBLEMS[name][0]
    b = _rhs(shape)
    x, info = tmg.setup(_problem(tmg, name), _config(tmg, name, inner),
                        device="cpu").solve(b)
    assert info["converged"] and ir["converged"]
    assert info["cycles"] == ir["cycles"], (info["residual_norms"],
                                            ir["residual_norms"])
    _same_history(info["residual_norms"], ir["residual_norms"])
    A = _matrix(name)
    assert np.linalg.norm(b.ravel() - A @ x.ravel()) < 1e-10 * 1.05
    assert np.linalg.norm((x - xr).ravel()) <= 2e-10 / _lam_min(A)


def test_w_second_visit_starts_from_the_first():
    """The W-cycle's second coarse visit starts from the first visit's
    correction (not from zero): with the fused paths declined the cycle is
    the same, composed of ``smooth``, ``residual`` and the transfers."""
    h = tmg.setup((16, 16, 16), _config(tmg, "poisson3d", "w"),
                  device="cpu").hierarchy
    r = to_t(rand((16, 16, 16), 6))
    w = tcycle.v_cycle(h, r, None, 0, 1, 1, gamma=2, x_zero=True)
    v = tcycle.v_cycle(h, r, None, 0, 1, 1, gamma=1, x_zero=True)
    assert float((w - v).abs().max()) > 1e-3 * float(v.abs().max())

    def composed(level, b, x):
        from openmg_tpu_torch.ops.smoothers import smooth
        from openmg_tpu_torch.ops.stencil import residual
        from openmg_tpu_torch.ops.transfer import prolong, restrict

        L = h.levels[level]
        if level == h.num_levels - 1:
            return tcycle.coarse_solve(h, b)
        x = smooth("rbgs", L.A, L.inv_diag, b, x, 1, OMEGA)
        bc = restrict(residual(L.A, b, x), h.transfer)
        ec = torch.zeros_like(bc)
        for _ in range(1 if level == h.num_levels - 2 else 2):
            ec = composed(level + 1, bc, ec)
        x = x + prolong(ec, L.grid_shape, h.transfer)
        return smooth("rbgs", L.A, L.inv_diag, b, x, 1, OMEGA)

    assert_close(w, composed(0, r, torch.zeros_like(r)), factor=5e-6, what="W")


# ---------------------------------------------------------------------------
# the sparse engine
# ---------------------------------------------------------------------------

SPARSE = {
    # krylov="pcg" on ELL, as tests/test_algebraic.py::test_pcg_on_general_engine
    "ell-pcg": (lambda: jmg.poisson((32, 32)), (32, 32), 1, dict(
        format="ell", smoother="rbgs", krylov="pcg", krylov_iters=2)),
    # ... and on BSR (2D elasticity, B=2, Jacobi)
    "bsr-pcg": (lambda: jmg.elasticity((16, 16)), (16, 16), 2, dict(
        format="bsr", blocksize=2, smoother="jacobi", krylov="pcg",
        krylov_iters=2)),
}


def _sparse_config(pkg, kw):
    return pkg.SolverConfig(transfer="linear", gridlevels=3,
                            max_dense_coarse=4096, cycles=60, **kw)


@pytest.mark.parametrize("case", list(SPARSE))
def test_sparse_pcg_matches_reference(case):
    build, shape, dofs, kw = SPARSE[case]
    A = build()
    b = _rhs(A.shape[0], 2)
    xr, ir = jmg.setup_sparse(A, shape, _sparse_config(
        jmg, {**kw, "outer_loop": "host"}), dofs=dofs).solve(b)
    xp, ip = tmg.setup_sparse(A, shape, _sparse_config(tmg, kw), dofs=dofs,
                              device="cpu").solve(b)
    assert ip["converged"] and ir["converged"]
    assert ip["cycles"] == ir["cycles"], (ip["residual_norms"],
                                          ir["residual_norms"])
    _same_history(ip["residual_norms"], ir["residual_norms"])
    assert np.linalg.norm(b - A @ xp) < 1e-10 * 1.05
    assert np.linalg.norm(xp - np.asarray(xr)) <= 2e-10 / _lam_min(A)


def test_sparse_fmg_through_mg_solve_matches_reference():
    shape = (32, 32)
    A = tmg.poisson(shape)
    b = _rhs(A.shape[0], 3)
    params = {"problemshape": shape, "format": "ell", "cycle_type": "f",
              "smoother": "rbgs", "transfer": "linear", "gridlevels": 3,
              "max_dense_coarse": 4096}
    xr, ir = jmg.mg_solve(A, b, {**params, "outer_loop": "host"})
    xp, ip = tmg.mg_solve(A, b, params, device="cpu")
    assert ip["format"] == "ell" and ip["converged"] and ir["converged"]
    assert ip["cycles"] == ir["cycles"]
    _same_history(ip["residual_norms"], ir["residual_norms"])
    assert np.linalg.norm(xp - np.asarray(xr)) <= 2e-10 / _lam_min(A)
    # setup_sparse with the same settings takes the same path
    cfg = tmg.SolverConfig(format="ell", cycle_type="f", smoother="rbgs",
                           transfer="linear", gridlevels=3,
                           max_dense_coarse=4096)
    xs, _ = tmg.setup_sparse(A, shape, cfg, device="cpu").solve(b)
    np.testing.assert_array_equal(xs, xp)


# ---------------------------------------------------------------------------
# solve_many
# ---------------------------------------------------------------------------

MANY_SHAPE = (16, 16)


def _many_rhs(n_or_shape):
    rhs = [np.random.default_rng(s).standard_normal(n_or_shape) for s in (1, 2, 3)]
    rhs[1] = rhs[1] * 1e-3  # converges in fewer cycles
    return rhs


def _many_config(pkg, **kw):
    return pkg.SolverConfig(smoother="jacobi", pre_iterations=1,
                            post_iterations=1, transfer="linear",
                            residual_dtype="doublefloat", gridlevels=3,
                            max_dense_coarse=64, cycles=60, **kw)


@pytest.fixture(scope="module")
def stencil_many():
    rhs = _many_rhs(MANY_SHAPE)
    _, ir = jmg.setup(MANY_SHAPE, _many_config(jmg)).solve_many(rhs)
    solver = tmg.setup(MANY_SHAPE, _many_config(tmg), device="cpu")
    xs, info = solver.solve_many(rhs)
    return solver, rhs, xs, info, ir


def test_solve_many_matches_scalar_solves(stencil_many):
    solver, rhs, xs, info, ir = stencil_many
    assert info["batch"] == 3 and xs.shape == (3,) + MANY_SHAPE
    assert xs.dtype == np.float64
    assert info["cycles"] == ir["cycles"]
    assert info["cycles"][1] < info["cycles"][0]
    # one host read of the batch's norms before the first step and after
    # every step
    assert info["host_reads"] == max(info["cycles"]) + 1
    for k, b in enumerate(rhs):
        xk, ik = solver.solve(b)
        np.testing.assert_array_equal(xs[k], xk)
        assert info["residual_norms"][k] == ik["residual_norms"]
        assert info["converged"][k] and info["final_norm"][k] == ik["final_norm"]


def test_solve_many_honours_initial_guesses(stencil_many):
    solver, rhs, _, _, _ = stencil_many
    x0s = [np.random.default_rng(s).standard_normal(MANY_SHAPE) * 0.1
           for s in (23, 24, 25)]
    xs, info = solver.solve_many(rhs, x0s=x0s)
    for k, b in enumerate(rhs):
        xk, ik = solver.solve(b, x0=x0s[k])
        np.testing.assert_array_equal(xs[k], xk)
        assert info["cycles"][k] == ik["cycles"]
    with pytest.raises(ValueError, match="initial guesses"):
        solver.solve_many(rhs, x0s=x0s[:2])


@pytest.mark.parametrize("inner", ["w", "pcg"])
def test_solve_many_device_native(stencil_many, inner):
    """A float32 tensor batch on the solver's device: the float32 hi parts
    as a tensor, the pairs in ``info['x_df']``, each member bit-equal to the
    scalar solve of that tensor; with a W cycle and with PCG too."""
    _, rhs, _, _, _ = stencil_many
    solver = tmg.setup(MANY_SHAPE, _many_config(tmg, **INNER[inner]),
                       device="cpu")
    bs = torch.from_numpy(np.stack(rhs).astype(np.float32))
    xs, info = solver.solve_many(bs)
    assert isinstance(xs, torch.Tensor) and xs.dtype == torch.float32
    assert tuple(xs.shape) == (3,) + MANY_SHAPE
    hi, lo = info["x_df"]
    assert xs is hi and lo.shape == hi.shape
    for k in range(3):
        xk, ik = solver.solve(bs[k].clone())
        assert torch.equal(hi[k], xk) and torch.equal(lo[k], ik["x_df"][1])
        assert info["cycles"][k] == ik["cycles"]


def test_sparse_solve_many():
    shape = MANY_SHAPE
    A = tmg.poisson(shape)
    n = A.shape[0]
    rhs = _many_rhs(n)
    cfg = dict(format="ell", smoother="jacobi", transfer="linear", gridlevels=3,
               max_dense_coarse=4096, cycles=60)
    _, ir = jmg.setup_sparse(A, shape, jmg.SolverConfig(**cfg)).solve_many(rhs)
    solver = tmg.setup_sparse(A, shape, tmg.SolverConfig(**cfg), device="cpu")
    xs, info = solver.solve_many(rhs)
    assert info["batch"] == 3 and xs.shape == (3, n) and xs.dtype == np.float64
    assert info["cycles"] == ir["cycles"]
    assert info["cycles"][1] < info["cycles"][0]
    assert info["host_reads"] == max(info["cycles"]) + 1
    for k, b in enumerate(rhs):
        xk, ik = solver.solve(b)
        np.testing.assert_array_equal(xs[k], xk)
        assert info["residual_norms"][k] == ik["residual_norms"]
    # the device-native batch and initial guesses
    bs = torch.from_numpy(np.stack(rhs).astype(np.float32))
    xd, idn = solver.solve_many(bs, x0s=[None, None, rhs[2] * 0.1])
    assert isinstance(xd, torch.Tensor) and xd is idn["x_df"][0]
    for k in range(3):
        x0 = None if k < 2 else rhs[2] * 0.1
        xk, ik = solver.solve(bs[k].clone(), x0=x0)
        assert torch.equal(xd[k], xk) and idn["cycles"][k] == ik["cycles"]
