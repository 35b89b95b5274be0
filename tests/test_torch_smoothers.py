"""The rest of the stencil engine's smoothers and operators on the CPU
against the JAX package: the 4th-kind Chebyshev smoother with its Gershgorin
bound on constant, cornered, faced and varying operators (3D and 2D), the
full inverse diagonal of a cornered operator, the faced operator
(``FacedStencilOperator``) against the reference and against its own
varying form, and Chebyshev solves with the reference's cycle counts.

Inputs come from numpy seeds and go to both packages.  The reference
hierarchies (16³ and 16², linear transfers) are set up once, in a
module-scoped fixture; at these widths the JAX package takes its array
code (no Pallas trace).
"""

import jax
import numpy as np
import pytest
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.core import hierarchy as jhier
from openmg_tpu.ops import smoothers as jsm
from openmg_tpu.ops import stencil as jst
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.ops import smoothers as tsm
from openmg_tpu_torch.ops import stencil as tst

from _torch_parity import assert_close, port_op, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

OMEGA = 2.0 / 3.0
SHAPES = {"3d": (16, 16, 16), "2d": (16, 16)}
KW = {"3d": dict(gridlevels=3, max_dense_coarse=64),
      "2d": dict(gridlevels=3, max_dense_coarse=16)}
KINDS = ("constant", "cornered", "faced", "varying")


def _jax_faced(Lv):
    """The reference's faced operator of a varying level (its detect_faced on
    the coefficient grids, as tests/test_faced.py builds it)."""
    C = np.asarray(Lv.A.coeffs)
    vals, face_axes, planes = jhier.detect_faced(Lv.A.offsets, C)
    return jst.FacedStencilOperator(
        values=to_j(vals), face_coeffs=tuple(to_j(p) for p in planes),
        offsets=Lv.A.offsets, shape=Lv.A.grid_shape, face_axes=face_axes,
    )


@pytest.fixture(scope="module")
def ops():
    """Per dimension and kind: the reference's operator and inv_diag, the
    port's, and the port's varying form of the same level."""
    out = {}
    for dim, shape in SHAPES.items():
        cfg = jmg.SolverConfig(smoother="rbgs", transfer="linear", **KW[dim])
        hf = jmg.setup(shape, cfg, faced=True).hierarchy
        hv = jmg.setup(shape, cfg, faced=False).hierarchy
        L0, Lc, Lv = hf.levels[0], hf.levels[1], hv.levels[1]
        assert isinstance(Lc.A, jst.CorneredOperator)
        varying_t = port_op(Lv.A)
        jops = {
            "constant": (L0.A, L0.inv_diag),
            "cornered": (Lc.A, None),
            "faced": (_jax_faced(Lv), None),
            "varying": (Lv.A, Lv.inv_diag),
        }
        for kind, (ja, jinv) in jops.items():
            ta = port_op(ja)
            tinv = None if jinv is None else to_t(np.asarray(jinv))
            out[dim, kind] = dict(j=(ja, jinv), t=(ta, tinv), vary=varying_t,
                                  vary_inv=to_t(np.asarray(Lv.inv_diag)))
    return out


def _bx(shape, seed):
    return rand(shape, seed), rand(shape, seed + 1)


def test_chebyshev_k1_equals_jacobi_two_thirds():
    """One Chebyshev iteration with λmax = 2 is ω = 2/3 weighted Jacobi."""
    shape = (16, 16)
    vals = torch.tensor([4.0, -1.0, -1.0, -1.0, -1.0])
    op = tst.StencilOperator(None, tpoisson.poisson_offsets(2), vals, shape)
    inv_d = torch.tensor(0.25)
    b, x = to_t(tpoisson.rhs_random(shape, seed=0)), to_t(tpoisson.rhs_random(shape, seed=1))
    got = tsm.chebyshev(op, inv_d, b, x, 1)
    want = tsm.jacobi(op, inv_d, b, x, 1, OMEGA)
    np.testing.assert_allclose(to_n(got), to_n(want), rtol=1e-6, atol=1e-6)
    assert float(tsm.gershgorin_lambda_max(op, inv_d)) == 2.0


@pytest.mark.parametrize("dim", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_gershgorin_matches_reference(ops, dim, kind):
    c = ops[dim, kind]
    want = float(jsm.gershgorin_lambda_max(*c["j"]))
    got = tsm.gershgorin_lambda_max(*c["t"])
    assert got.ndim == 0 and got.device.type == "cpu"
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("dim", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_chebyshev_smoothing_matches_reference(ops, dim, kind):
    """One ``smooth("chebyshev", ...)`` call of two iterations (each kind
    dispatched to its own inverse diagonal) against the reference's."""
    c = ops[dim, kind]
    ja, jinv = c["j"]
    ta, tinv = c["t"]
    b, x = _bx(ta.grid_shape, 3)
    # one traced program: the reference's op-by-op dispatch costs seconds
    want = jax.jit(lambda bb, xx: jsm.smooth("chebyshev", ja, jinv, bb, xx, 2, OMEGA))(
        to_j(b), to_j(x))
    got = tsm.smooth("chebyshev", ta, tinv, to_t(b), to_t(x), 2, OMEGA)
    assert_close(got, want, factor=2e-6, what=f"chebyshev {dim} {kind}")


@pytest.mark.parametrize("dim", SHAPES)
def test_cornered_inv_diag_full_bit_equal(ops, dim):
    ja = ops[dim, "cornered"]["j"][0]
    ta = ops[dim, "cornered"]["t"][0]
    got = tsm.cornered_inv_diag_full(ta)
    np.testing.assert_array_equal(to_n(got), np.asarray(jsm.cornered_inv_diag_full(ja)))


@pytest.mark.parametrize("dim", SHAPES)
def test_faced_to_varying_bit_equal(ops, dim):
    c = ops[dim, "faced"]
    ja, ta = c["j"][0], c["t"][0]
    got = ta.to_varying().coeffs
    np.testing.assert_array_equal(to_n(got), np.asarray(ja.to_varying().coeffs))
    assert torch.equal(got, c["vary"].coeffs)


@pytest.mark.parametrize("dim", SHAPES)
@pytest.mark.parametrize("what", ["apply", "residual", "jacobi", "rbgs"])
def test_faced_operator_matches_reference_and_varying(ops, dim, what):
    """apply, residual and one Jacobi / red-black smoothing call of the faced
    operator within 1e-5 absolute of the reference's and of the port's
    varying form of the same level."""
    c = ops[dim, "faced"]
    ja, ta, tv = c["j"][0], c["t"][0], c["vary"]
    b, x = _bx(ta.grid_shape, 11)
    bt, xt, bj, xj = to_t(b), to_t(x), to_j(b), to_j(x)
    if what == "apply":
        got, vary = tst.apply(ta, xt), tst.apply(tv, xt)
        want = jax.jit(lambda bb, xx: jst.apply(ja, xx))(bj, xj)
    elif what == "residual":
        got, vary = tst.residual(ta, bt, xt), tst.residual(tv, bt, xt)
        want = jax.jit(lambda bb, xx: jst.residual(ja, bb, xx))(bj, xj)
    else:
        got = tsm.smooth(what, ta, None, bt, xt, 2, OMEGA)
        vary = tsm.smooth(what, tv, c["vary_inv"], bt, xt, 2, OMEGA)
        want = jax.jit(lambda bb, xx: jsm.smooth(what, ja, None, bb, xx, 2, OMEGA))(bj, xj)
    for ref, name in ((want, "reference"), (vary, "varying form")):
        err = float(np.max(np.abs(to_n(got).astype(np.float64) - to_n(ref))))
        assert err <= 1e-5, f"{what} {dim}: {err:.3e} from the {name}"


@pytest.mark.parametrize("shape,kw", [
    # two levels: the reference's solve compiles in half the time of three
    ((16, 16, 16), dict(gridlevels=2, max_dense_coarse=512)),
    ((32, 32), dict(max_dense_coarse=16)),
], ids=["16^3", "32^2"])
def test_chebyshev_solve_takes_the_reference_cycles(shape, kw):
    cfg = dict(smoother="chebyshev", transfer="linear", cycles=60,
               residual_dtype="doublefloat", **kw)
    b = tpoisson.rhs_random(shape, seed=5)
    _, ij = jmg.setup(shape, jmg.SolverConfig(**cfg)).solve(b)
    xt, it = tmg.setup(shape, tmg.SolverConfig(**cfg), device="cpu").solve(b)
    assert it["converged"] and ij["converged"]
    assert it["cycles"] == ij["cycles"], (it["cycles"], ij["cycles"])
    r = b.ravel() - tpoisson.poisson(shape) @ np.asarray(xt).ravel()
    assert np.linalg.norm(r) < 1e-10 * 1.05
