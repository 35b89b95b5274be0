"""Port vs JAX package: configuration, problem generators, transfers,
stencil operators, double-float helpers and the hierarchy setup.

Host-side tables must be equal bit for bit (they are computed by copied
numpy code); float32 tensor functions agree to 1 ulp-scale tolerances,
stated at each comparison.
"""

import dataclasses

import numpy as np
import pytest
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.ops import doublefloat as jdf
from openmg_tpu.ops import smoothers as jsm
from openmg_tpu.ops import stencil as jst
from openmg_tpu.ops import transfer as jtr
from openmg_tpu_torch.core import hierarchy as thier
from openmg_tpu_torch.ops import doublefloat as tdf
from openmg_tpu_torch.ops import smoothers as tsm
from openmg_tpu_torch.ops import stencil as tst
from openmg_tpu_torch.ops import transfer as ttr

from _torch_parity import assert_close, port_op, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

SHAPE = (32, 32, 64)
CFG_KW = dict(
    smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
    gridlevels=3, max_dense_coarse=1024,
)


@pytest.fixture(scope="module")
def hierarchies():
    hj = jmg.setup(SHAPE, jmg.SolverConfig(**CFG_KW)).hierarchy
    ht = tmg.setup(SHAPE, tmg.SolverConfig(**CFG_KW), device="cpu").hierarchy
    return hj, ht


def test_config_json_round_trip_and_defaults():
    ct = tmg.SolverConfig(**CFG_KW, cycles=60)
    assert tmg.SolverConfig.from_json(ct.to_json()) == ct
    cj = jmg.SolverConfig(**CFG_KW, cycles=60)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert ct.to_json() == cj.to_json()
    assert dataclasses.asdict(tmg.SolverConfig()) == dataclasses.asdict(
        jmg.SolverConfig()
    )
    pt = tmg.ProblemConfig(shape=(4, 4, 4), rhs="ones", seed=3)
    assert pt.to_json() == jmg.ProblemConfig(shape=(4, 4, 4), rhs="ones", seed=3).to_json()


def test_config_from_parameters_matches():
    params = {
        "problemshape": (8, 8, 8), "gridlevels": 2, "iterations": 3,
        "cycles": 7, "threshold": 1e-8, "transfer": "linear",
        "smoother": "jacobi", "max_dense_coarse": 64,
    }
    assert dataclasses.asdict(
        tmg.SolverConfig.from_parameters(params)
    ) == dataclasses.asdict(jmg.SolverConfig.from_parameters(params))
    with pytest.raises(ValueError):
        tmg.SolverConfig.from_parameters({"nonsense": 1})
    with pytest.raises(ValueError):
        tmg.SolverConfig(smoother="sor")


@pytest.mark.parametrize("seed", [0, 1])
def test_rhs_bit_equal(seed):
    from openmg_tpu.models.poisson import rhs_ones, rhs_random

    a = tmg.rhs_random((5, 6, 7), seed=seed)
    np.testing.assert_array_equal(a, rhs_random((5, 6, 7), seed=seed))
    assert a.dtype == np.float64
    np.testing.assert_array_equal(tmg.rhs_ones((3, 4)), rhs_ones((3, 4)))


def test_poisson_assembly_equal():
    from openmg_tpu.models.poisson import poisson_offsets
    from openmg_tpu_torch.models.poisson import poisson_offsets as t_offsets

    assert t_offsets(3) == poisson_offsets(3)
    oj, cj = jmg.poisson_stencil((4, 5, 6))
    ot, ct = tmg.poisson_stencil((4, 5, 6))
    assert ot == oj
    np.testing.assert_array_equal(ct, cj)
    assert (tmg.poisson((4, 5, 6)) != jmg.poisson((4, 5, 6))).nnz == 0
    assert (tmg.stencil_to_csr(ot, ct) != tmg.poisson((4, 5, 6))).nnz == 0


@pytest.mark.parametrize("name", ["aggregate", "linear"])
def test_restrict_prolong_match(name):
    """≤ 1 ulp of float32 at the data's scale: the taps are powers of two,
    only the order of at most three adds per axis could differ."""
    v = rand((8, 12, 16), 3)
    u = rand((4, 6, 8), 4)
    assert ttr.coarse_shape((8, 12, 1)) == jtr.coarse_shape((8, 12, 1))
    rj = jtr.restrict(to_j(v), jtr.TRANSFERS[name])
    rt = ttr.restrict(to_t(v), ttr.TRANSFERS[name])
    assert_close(rt, rj, factor=1.2e-7, what="restrict")
    pj = jtr.prolong(to_j(u), (8, 12, 16), jtr.TRANSFERS[name])
    pt = ttr.prolong(to_t(u), (8, 12, 16), ttr.TRANSFERS[name])
    assert_close(pt, pj, factor=1.2e-7, what="prolong")
    with pytest.raises(ValueError):
        ttr.prolong(to_t(u), (8, 12, 15), ttr.TRANSFERS[name])


@pytest.mark.parametrize(
    "shape,mdc",
    [((256, 256, 256), 4096), ((32, 32, 64), 1024), ((12, 20, 40), 64), ((7, 8, 8), 16)],
)
def test_default_gridlevels_match(shape, mdc):
    from openmg_tpu.core.hierarchy import default_gridlevels

    assert thier.default_gridlevels(shape, mdc) == default_gridlevels(shape, mdc)


def test_hierarchy_tables_bit_equal(hierarchies):
    hj, ht = hierarchies
    assert ht.num_levels == hj.num_levels == 3
    assert ht.transfer.name == hj.transfer.name
    assert ht.stats == tuple(hj.stats)
    kinds = []
    for Lj, Lt in zip(hj.levels, ht.levels):
        Aj, At = Lj.A, Lt.A
        cornered = isinstance(Aj, jst.CorneredOperator)
        assert isinstance(At, tst.CorneredOperator) == cornered
        kinds.append("cornered" if cornered else "const")
        assert At.offsets == tuple(Aj.offsets)
        assert At.grid_shape == tuple(Aj.grid_shape)
        assert At.values.dtype == torch.float32
        np.testing.assert_array_equal(to_n(At.values), np.asarray(Aj.values))
        np.testing.assert_array_equal(to_n(Lt.inv_diag), np.asarray(Lj.inv_diag))
        if cornered:
            assert At.subsets == tuple(Aj.subsets)
            assert At.regions == tuple(Aj.regions)
            assert At.face_axes == tuple(Aj.face_axes)
            np.testing.assert_array_equal(to_n(At.deltas), np.asarray(Aj.deltas))
            np.testing.assert_array_equal(
                to_n(tst.region_table(At)), np.asarray(jst.region_table(Aj))
            )
    assert kinds == ["const", "cornered", "cornered"]
    np.testing.assert_array_equal(
        to_n(ht.fine_hi_lo.values), np.asarray(hj.fine_hi_lo.values)
    )


def test_hierarchy_coarse_inverse(hierarchies):
    """f64 inverse cast to f32 on both sides: 1e-6 relative."""
    hj, ht = hierarchies
    cj = np.asarray(hj.coarse_inv)
    ct = to_n(ht.coarse_inv)
    assert ct.shape == cj.shape == (1024, 1024) and ct.dtype == np.float32
    assert np.max(np.abs(ct - cj)) <= 1e-6 * np.max(np.abs(cj))


def test_aggregate_hierarchy_is_constant():
    kw = dict(CFG_KW, transfer="aggregate")
    hj = jmg.setup(SHAPE, jmg.SolverConfig(**kw)).hierarchy
    ht = tmg.setup(SHAPE, tmg.SolverConfig(**kw), device="cpu").hierarchy
    assert ht.stats == tuple(hj.stats)
    for Lj, Lt in zip(hj.levels, ht.levels):
        assert Lt.A.is_constant and Lj.A.is_constant
        assert Lt.A.offsets == tuple(Lj.A.offsets)
        np.testing.assert_array_equal(to_n(Lt.A.values), np.asarray(Lj.A.values))


@pytest.mark.parametrize("level", [0, 1])
def test_apply_residual_match(hierarchies, level):
    """Plain tensor SpMV / residual vs the JAX package's: same terms in the
    same order, up to fused multiply-adds on the XLA side (2e-6·max|ref|)."""
    hj, ht = hierarchies
    Aj, At = hj.levels[level].A, ht.levels[level].A
    x = rand(At.grid_shape, 5)
    b = rand(At.grid_shape, 6)
    assert_close(tst.apply(At, to_t(x)), jst.apply(Aj, to_j(x)), what="apply")
    assert_close(
        tst.residual(At, to_t(b), to_t(x)),
        to_j(b) - jst.apply(Aj, to_j(x)),
        what="residual",
    )


def test_shift_matches():
    x = rand((4, 5, 6), 7)
    for off in [(0, 0, 0), (1, 0, 0), (0, -1, 1), (-1, 1, -1)]:
        np.testing.assert_array_equal(
            to_n(tst.shift(to_t(x), off)), np.asarray(jst.shift(to_j(x), off))
        )


def test_cornered_to_varying_matches(hierarchies):
    hj, ht = hierarchies
    vj = hj.levels[2].A.to_varying()
    vt = ht.levels[2].A.to_varying()
    assert not vt.is_constant and vt.offsets == tuple(vj.offsets)
    np.testing.assert_array_equal(to_n(vt.coeffs), np.asarray(vj.coeffs))
    x = rand(vt.grid_shape, 8)
    assert_close(tst.apply(vt, to_t(x)), tst.apply(ht.levels[2].A, to_t(x)))


@pytest.mark.parametrize("name", ["jacobi", "rbgs"])
@pytest.mark.parametrize("level", [0, 1])
def test_smoothers_match(hierarchies, name, level):
    """The port's smoothers (x + r/diag through ``residual``) vs the JAX
    package's jnp smoothers: a different but equivalent formulation, so
    5e-6·max|ref| after two sweeps."""
    hj, ht = hierarchies
    Lj, Lt = hj.levels[level], ht.levels[level]
    b = rand(Lt.grid_shape, 9)
    x = rand(Lt.grid_shape, 10)
    want = jsm.smooth(
        name, Lj.A, Lj.inv_diag, to_j(b), to_j(x), 2, 2.0 / 3.0, use_pallas=False
    )
    got = tsm.smooth(name, Lt.A, Lt.inv_diag, to_t(b), to_t(x), 2, 2.0 / 3.0)
    assert_close(got, want, factor=5e-6, what=name)


def test_doublefloat_host_helpers_match():
    for v in [6.0, -1.0, 4.0, 0.75, 0.1, 7.0, 15.0, 0.0]:
        assert tdf.pow2_terms(v) == jdf.pow2_terms(v)
    a = np.random.default_rng(11).standard_normal((3, 4, 5))
    th, tl = tdf.df_split(a)
    jh, jl = jdf.df_split(a)
    np.testing.assert_array_equal(to_n(th), np.asarray(jh))
    np.testing.assert_array_equal(to_n(tl), np.asarray(jl))
    np.testing.assert_array_equal(tdf.df_merge((th, tl)), jdf.df_merge((jh, jl)))
    np.testing.assert_array_equal(tdf.df_merge((th, tl)), a.astype(np.float32).astype(np.float64) + to_n(tl))


def test_doublefloat_tensor_ops_bit_equal():
    """Adds and subtracts only, never reassociated by either framework."""
    rng = np.random.default_rng(12)
    xs = [(rng.standard_normal((6, 7)) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
          for _ in range(5)]
    a, b, c, d, e = xs
    c, d = c * 1e-7, d * 1e-7
    for tf, jf_, args in [
        (tdf.two_sum, jdf.two_sum, (a, b)),
        (tdf.quick_two_sum, jdf.quick_two_sum, (a, c)),
    ]:
        got = tf(*map(to_t, args))
        want = jf_(*map(to_j, args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_n(g), np.asarray(w))
    got = tdf.df_add_f32((to_t(a), to_t(c)), to_t(e))
    want = jdf.df_add_f32((to_j(a), to_j(c)), to_j(e))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_n(g), np.asarray(w))
    got = tdf.df_sub((to_t(a), to_t(c)), (to_t(b), to_t(d)))
    want = jdf.df_sub((to_j(a), to_j(c)), (to_j(b), to_j(d)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_n(g), np.asarray(w))


def test_classify_raises_for_unported_levels():
    """A level that is neither constant nor cornered is refused, naming the
    ROADMAP item — never run through another representation."""
    offs = ((0, 0, 0), (0, 0, 1), (0, 0, -1))
    rng = np.random.default_rng(13)
    rep = rng.standard_normal((3, 6, 6, 6))
    assert thier.classify_level(offs, rep)[0] == "varying"
    const = np.zeros((3, 6, 6, 6))
    const[0] = 2.0
    const[1, :, :, :-1] = -1.0
    const[2, :, :, 1:] = -1.0
    assert thier.classify_level(offs, const)[0] == "const"


# ---------------------------------------------------------------------------
# setup(..., faced=False): every level that is not constant as coefficient
# grids, as in the JAX package; one reference setup and solve at 16³
# ---------------------------------------------------------------------------

UNFACED_SHAPE = (16, 16, 16)
UNFACED_KW = dict(
    smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
    gridlevels=3, max_dense_coarse=64,
)


def _unfaced_rhs():
    b = tmg.rhs_random(UNFACED_SHAPE, seed=1)
    return b / np.linalg.norm(b)


@pytest.fixture(scope="module")
def unfaced():
    """The reference's and the port's ``faced=False`` setup and solve (the
    reference's array path: no Pallas kernel takes nx = 16)."""
    b = _unfaced_rhs()
    sj = jmg.setup(UNFACED_SHAPE, jmg.SolverConfig(**UNFACED_KW), faced=False)
    xj, ij = sj.solve(b)
    st = tmg.setup(UNFACED_SHAPE, tmg.SolverConfig(**UNFACED_KW), device="cpu",
                   faced=False)
    xt, it = st.solve(b)
    return sj.hierarchy, np.asarray(xj), ij, st.hierarchy, xt, it


def test_unfaced_setup_matches_reference(unfaced):
    """The same level kinds; the coefficient grids and the per-point
    ``inv_diag`` equal bit for bit (both expand the float32 representative
    by copies and divide once in float32)."""
    hj, _, _, ht, _, _ = unfaced
    assert ht.stats == tuple(hj.stats)
    kinds = []
    for i, (Lt, Lj) in enumerate(zip(ht.levels, hj.levels)):
        assert type(Lt.A).__name__ == type(Lj.A).__name__ == "StencilOperator"
        assert Lt.A.is_constant == Lj.A.is_constant, i
        kinds.append("const" if Lt.A.is_constant else "varying")
        if not Lt.A.is_constant:
            assert Lt.A.coeffs.is_contiguous()
            np.testing.assert_array_equal(to_n(Lt.A.coeffs), np.asarray(Lj.A.coeffs))
        np.testing.assert_array_equal(to_n(Lt.inv_diag), np.asarray(Lj.inv_diag))
    assert kinds == ["const", "varying", "varying"]
    np.testing.assert_array_equal(to_n(ht.coarse_inv), np.asarray(hj.coarse_inv))


def test_unfaced_solve_matches_reference(unfaced):
    """The same cycle count, residual norms within 10 %, and both solutions
    within the threshold of one exact solution (‖Δx‖₂ ≤ 2e-10/λ_min)."""
    _, xj, ij, _, xt, it = unfaced
    assert it["converged"] and ij["converged"]
    assert it["cycles"] == ij["cycles"]
    for a, r in zip(it["residual_norms"], ij["residual_norms"]):
        assert r / 1.1 <= a <= r * 1.1
    lam_min = sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in UNFACED_SHAPE)
    assert np.linalg.norm((xt - xj).ravel()) <= 2e-10 / lam_min


def test_faced_default_keeps_constant_and_cornered_levels(unfaced):
    """The default ``faced=True`` builds the constant and cornered levels it
    built before, whose operators equal the unfaced grids point by point."""
    ht_unfaced = unfaced[3]
    cfg = tmg.SolverConfig(**UNFACED_KW)
    ht = tmg.setup(UNFACED_SHAPE, cfg, device="cpu").hierarchy
    explicit = tmg.setup(UNFACED_SHAPE, cfg, device="cpu", faced=True).hierarchy
    assert [type(L.A).__name__ for L in ht.levels] == [
        "StencilOperator", "CorneredOperator", "CorneredOperator"]
    for L, Le, Lu in zip(ht.levels, explicit.levels, ht_unfaced.levels):
        assert type(L.A) is type(Le.A)
        assert torch.equal(L.inv_diag, Le.inv_diag)
        if isinstance(L.A, tst.CorneredOperator):
            assert torch.equal(L.A.to_varying().coeffs, Lu.A.coeffs)


def test_reference_names_are_exported():
    from openmg_tpu_torch import (  # noqa: F401
        BSRMatrix,
        CSRMatrix,
        ELLMatrix,
        build_hierarchy,
        from_scipy,
        to_scipy,
    )

    names = {"build_hierarchy", "CSRMatrix", "ELLMatrix", "BSRMatrix",
             "from_scipy", "to_scipy"}
    assert names <= set(tmg.__all__) and names <= set(jmg.__all__)
    assert build_hierarchy is thier.build_hierarchy
    import scipy.sparse as sp

    A = sp.random(12, 12, density=0.3, random_state=0, format="csr") + sp.eye(12)
    M = from_scipy(A, "ell", dtype=np.float64, device="cpu")
    assert isinstance(M, ELLMatrix)
    assert abs(to_scipy(M) - A).max() == 0
