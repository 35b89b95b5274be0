"""Setup on the device on the CPU against the JAX package:
``build_hierarchy_device`` at 16³ for Poisson (``fine_values``) and for a
diffusion stencil (``coeffs``), level by level against the reference's
(offsets, coefficients, inverse diagonals, statistics), against the port's
host chain, and a solve on each with the reference's cycle count.
``galerkin_rap_device`` against the host RAP.

The reference's device build and solves run once per problem, in a
module-scoped fixture (its setup program at 16³ compiles in seconds).
"""

import numpy as np
import pytest
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.core import hierarchy as jhier
from openmg_tpu.core.solver import Solver as JSolver
from openmg_tpu.ops.transfer import TRANSFERS as JTRANSFERS
from openmg_tpu_torch.core import hierarchy as thier
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.ops import galerkin as tgal
from openmg_tpu_torch.ops.transfer import TRANSFERS as TTRANSFERS

from _torch_parity import to_j, to_n
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

SHAPE = (16, 16, 16)
# two levels against the reference (its setup program and solve compile for
# half as long as at three); the port's chain is held against its host
# chain at three levels, where the second step maps 27 taps to 27
BUILD = dict(transfer="linear", gridlevels=2, max_dense_coarse=512)
DEEP = dict(BUILD, gridlevels=3, max_dense_coarse=64)
# Jacobi V(2,2): the reference's red/black solve compiles for four times as long
SOLVE = dict(smoother="jacobi", transfer="linear", residual_dtype="doublefloat",
             gridlevels=2, max_dense_coarse=512, cycles=100)


def _kappa():
    return 0.5 + np.random.default_rng(21).random(SHAPE)


def _problem(name):
    """``(offsets, kwargs of the build)`` of a problem."""
    if name == "poisson":
        return tpoisson.poisson_offsets(3), dict(fine_values=[6.0] + [-1.0] * 6,
                                                 shape=SHAPE)
    offsets, coeffs = tpoisson.diffusion_stencil(_kappa())
    return offsets, dict(coeffs=coeffs.astype(np.float32))


def _build(pkg, name, build=BUILD):
    offsets, kw = _problem(name)
    common = dict(gridlevels=build["gridlevels"],
                  max_dense_coarse=build["max_dense_coarse"])
    if pkg == "jax":
        if "coeffs" in kw:
            kw = dict(coeffs=to_j(kw["coeffs"]))
        return jhier.build_hierarchy_device(
            offsets, transfer=JTRANSFERS[build["transfer"]], **kw, **common)
    return thier.build_hierarchy_device(
        offsets, transfer=TTRANSFERS[build["transfer"]], device="cpu",
        **kw, **common)


@pytest.fixture(scope="module", params=["poisson", "diffusion"])
def built(request):
    """The reference's and the port's device-built hierarchies of one
    problem, and a solve on each."""
    name = request.param
    hj, ht = _build("jax", name), _build("torch", name)
    b = tpoisson.rhs_random(SHAPE, seed=22)
    _, ij = JSolver(hj, jmg.SolverConfig(**SOLVE)).solve(b)
    xt, it = tmg.Solver(ht, tmg.SolverConfig(**SOLVE)).solve(b)
    return name, hj, ht, b, ij, xt, it


def _rel_close(got, want, rtol, what):
    got, want = to_n(got).astype(np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    tol = rtol * max(float(np.max(np.abs(want))), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} > {tol:.3e}"


def test_levels_match_reference(built):
    """Equal offsets, kinds and statistics; coefficients and inverse
    diagonals within 2e-6 relative (float32 sums)."""
    name, hj, ht = built[:3]
    assert ht.num_levels == hj.num_levels
    assert tuple(ht.stats) == tuple(
        (tuple(s), int(k), int(n)) for s, k, n in hj.stats)
    for i, (Lt, Lj) in enumerate(zip(ht.levels, hj.levels)):
        assert Lt.A.offsets == tuple(tuple(o) for o in Lj.A.offsets), (name, i)
        assert Lt.A.is_constant == Lj.A.is_constant, (name, i)
        if Lt.A.is_constant:
            _rel_close(Lt.A.values, Lj.A.values, 2e-6, f"{name} {i} values")
        else:
            _rel_close(Lt.A.coeffs, Lj.A.coeffs, 2e-6, f"{name} {i} coeffs")
        _rel_close(Lt.inv_diag, Lj.inv_diag, 2e-6, f"{name} {i} inv_diag")
    _rel_close(ht.coarse_inv, hj.coarse_inv, 2e-6, f"{name} coarse_inv")


@pytest.mark.parametrize("name", ["poisson", "diffusion"])
def test_levels_match_the_host_chain(name):
    """The device chain's levels equal the host chain's (``build_hierarchy``
    on the same float32 grids) bit for bit on the CPU, three levels deep."""
    ht = _build("torch", name, DEEP)
    offsets, kw = _problem(name)
    coeffs = kw.get("coeffs")
    if coeffs is None:
        coeffs = tpoisson.poisson_stencil(SHAPE)[1].astype(np.float32)
    hh = thier.build_hierarchy(
        offsets, coeffs, gridlevels=DEEP["gridlevels"],
        max_dense_coarse=DEEP["max_dense_coarse"],
        transfer=TTRANSFERS[DEEP["transfer"]], device="cpu")
    assert ht.num_levels == hh.num_levels == 3
    for Lt, Lh in zip(ht.levels, hh.levels):
        assert Lt.A.offsets == Lh.A.offsets
        assert Lt.A.is_constant == Lh.A.is_constant
        if Lt.A.is_constant:
            assert torch.equal(Lt.A.values, Lh.A.values)
        else:
            assert torch.equal(Lt.A.coeffs, Lh.A.coeffs)
        assert torch.equal(Lt.inv_diag.reshape(Lh.inv_diag.shape), Lh.inv_diag)
    assert tuple(ht.stats) == tuple(hh.stats)


def test_solve_takes_the_reference_cycles(built):
    name, _, ht, b, ij, xt, it = built
    assert it["converged"] and ij["converged"]
    assert it["cycles"] == ij["cycles"], (name, it["cycles"], ij["cycles"])
    # the device build solves the float32 operator it was given
    offsets, kw = _problem(name)
    if name == "poisson":
        A = tpoisson.poisson(SHAPE)
    else:
        A = tpoisson.stencil_to_csr(offsets, kw["coeffs"].astype(np.float64))
    assert np.linalg.norm(b.ravel() - A @ np.asarray(xt).ravel()) < 1e-10 * 1.05


def test_galerkin_rap_device_matches_host():
    """One RAP step on tensors (pruned by one device reduction) equals the
    host RAP on the same float32 grids."""
    offsets, coeffs = tpoisson.diffusion_stencil(_kappa())
    c32 = coeffs.astype(np.float32)
    tr = TTRANSFERS["linear"]
    offs_d, cur_d = tgal.galerkin_rap_device(offsets, torch.from_numpy(c32), tr)
    offs_h, cur_h = tgal.galerkin_rap_stencil(offsets, c32, transfer=tr)
    assert offs_d == offs_h
    np.testing.assert_array_equal(to_n(cur_d), cur_h)
