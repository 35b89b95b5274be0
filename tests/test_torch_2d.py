"""The 2D slice of the port on the CPU against the JAX package: the plain
version of the whole-visit 2D stage fusion (K5) against the Pallas kernel
in interpret mode, the 2D Poisson solve as a whole, the K2 lift, K3 on a
cornered 2D operator, the matrix and stencil-pair entry points in 2D, and
the device rule on the 2D path.

Inputs come from numpy seeds and go to both packages.  Everything of the
reference hangs off one module-scoped solve of the (64, 128) problem of
``tests/test_fused.py::_hier2d``: its hierarchy serves the three traced
kernel calls of (a).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.ops import kernels as jkernels
from openmg_tpu.ops.transfer import TRANSFERS as JTRANSFERS
from openmg_tpu_torch.core import cycle as tcycle
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import kernels as tkernels
from openmg_tpu_torch.ops import smoothers as tsmoothers
from openmg_tpu_torch.ops import stencil as tstencil
from openmg_tpu_torch.ops.transfer import TRANSFERS as TTRANSFERS
from openmg_tpu_torch.ops.transfer import prolong, restrict
from openmg_tpu_torch.utils.convert import hierarchy_from_numpy

from _torch_parity import (
    assert_close, port_op, rand, spec_from_jax_hierarchy, to_j, to_n, to_t,
)
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

SHAPE = (64, 128)
CFG_KW = dict(
    smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
    gridlevels=3, max_dense_coarse=4096,
)
OMEGA = 2.0 / 3.0


def _rhs(shape=SHAPE, seed=0):
    b = tmg.rhs_random(shape, seed=seed)
    return b / np.linalg.norm(b.ravel())


@pytest.fixture(scope="module")
def reference():
    solver = jmg.setup(SHAPE, jmg.SolverConfig(**CFG_KW))
    x, info = solver.solve(_rhs())
    return solver, np.asarray(x), info


@pytest.fixture(scope="module")
def port():
    solver = tmg.setup(SHAPE, tmg.SolverConfig(**CFG_KW), device="cpu")
    x, info = solver.solve(_rhs())
    return solver, x, info


# ---------------------------------------------------------------------------
# (a) K5's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

RB4 = (("rb", 0), ("rb", 1)) * 2
JAC3 = (("jacobi", OMEGA),) * 3


@pytest.mark.parametrize("case", ["const down-leg", "cornered up-leg",
                                  "cornered jacobi residual"])
def test_fused_stages_2d_plain_matches_reference_kernel(reference, case):
    """1e-5·max|ref| (a residual: 1e-5·max|b|): the reference sums a cornered
    operator's taps as four masked accumulators (constant part and three
    boundary deltas), the port picks one tap row a point, so the two differ
    in rounding on cornered levels; on the constant level they agree to a
    few ulp."""
    h = reference[0].hierarchy
    tr_j, tr_t = JTRANSFERS["linear"], TTRANSFERS["linear"]
    level = 0 if case.startswith("const") else 1
    A = h.levels[level].A
    op = port_op(A)
    shape = op.grid_shape
    cshape = tuple(s // 2 for s in shape)
    b, x, ec = rand(shape, 10), rand(shape, 11), rand(cshape, 12)
    jkw, tkw = {}, {}
    if level:
        jkw = dict(deltas=A.deltas, subsets=A.subsets)
        tkw = dict(corner=tfused._corner_info(op))
    if case == "const down-leg":
        jx, stages = None, RB4
        jkw.update(emit_residual=True, restrict_transfer=tr_j)
        tkw.update(emit_residual=True, restrict_transfer=tr_t)
    elif case == "cornered up-leg":
        jx, stages = x, RB4
        jkw.update(ec=to_j(ec), prolong_transfer=tr_j)
        tkw.update(ec=to_t(ec), prolong_transfer=tr_t)
    else:
        jx, stages = x, JAC3
        jkw.update(emit_residual=True)
        tkw.update(emit_residual=True)
    ref = jkernels.fused_stages_2d(A.values, A.offsets, to_j(b), to_j(jx),
                                   stages, **jkw)
    got = tkernels.fused_stages_2d(op.values, op.offsets, to_t(b), to_t(jx),
                                   stages, **tkw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    assert_close(got[0], ref[0], factor=1e-5, what=f"{case}: x")
    if len(ref) > 1:
        assert tuple(got[1].shape) == tuple(ref[1].shape)
        assert_close(got[1], ref[1], factor=1e-5, scale=b, what=f"{case}: r")


def test_split_visit_equals_one_visit(port, monkeypatch):
    """A visit deeper than one launch takes is split into consecutive calls;
    on the CPU the split calls give exactly the unsplit plain result."""
    L = port[0].hierarchy.levels[1]
    op, tr = L.A, TTRANSFERS["linear"]
    b, x = to_t(rand(L.grid_shape, 13)), to_t(rand(L.grid_shape, 14))
    ec = to_t(rand(tuple(s // 2 for s in L.grid_shape), 15))
    stages = RB4 * 3
    kw = dict(corner=tfused._corner_info(op), emit_residual=True,
              restrict_transfer=tr, ec=ec, prolong_transfer=tr)
    whole = tkernels.fused_stages_2d_plain(op.values, op.offsets, b, x, stages, **kw)
    calls = []
    real = tkernels.fused_stages_2d_plain

    def counted(*a, **k):
        calls.append(len(a[4]))
        return real(*a, **k)

    monkeypatch.setattr(tkernels, "MAX_DEPTH_2D", 5)
    monkeypatch.setattr(tkernels, "fused_stages_2d_plain", counted)
    split = tkernels.fused_stages_2d(op.values, op.offsets, b, x, stages, **kw)
    assert calls == [5, 5, 2]
    for a, c in zip(split, whole):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# (b) the 2D Poisson solve as a whole
# ---------------------------------------------------------------------------


def test_solve_matches_reference(reference, port):
    """Same cycle count, the history within 10 % (1.5× below 1e-9, near the
    double-float floor), and the solutions within 1e-9 of each other."""
    _, xr, ri = reference
    _, xp, pi = port
    assert isinstance(xp, np.ndarray) and xp.dtype == np.float64 and xp.shape == SHAPE
    assert pi["converged"] and ri["converged"]
    assert pi["cycles"] == ri["cycles"] == 7
    for k, (a, r) in enumerate(zip(pi["residual_norms"], ri["residual_norms"])):
        bound = 1.5 if r < 1e-9 else 1.1
        assert r / bound <= a <= r * bound, (k, a, r)
    assert float(np.max(np.abs(xp - xr))) <= 1e-9
    A = tpoisson.poisson(SHAPE)
    assert np.linalg.norm(_rhs().ravel() - A @ xp.ravel()) < 1e-10 * 1.05


def test_v_cycle_visits_every_level_through_the_2d_kernel(port, monkeypatch):
    """Each visited level is one K5 call on the way down and one on the way
    up; nothing is composed of the per-pass functions."""
    h = port[0].hierarchy
    calls = []
    real = tkernels.fused_stages_2d_plain

    def spy(values, offsets, b, x, stages, **kw):
        calls.append((tuple(b.shape), x is None, kw["ec"] is not None,
                      kw["restrict_transfer"] is not None))
        return real(values, offsets, b, x, stages, **kw)

    monkeypatch.setattr(tkernels, "fused_stages_2d_plain", spy)
    monkeypatch.setattr(tcycle, "smooth", lambda *a, **k: pytest.fail("composed"))
    tcycle.v_cycle(h, to_t(rand(SHAPE, 16)), None, x_zero=True)
    assert calls == [
        ((64, 128), True, False, True), ((32, 64), True, False, True),
        ((32, 64), False, True, False), ((64, 128), False, True, False),
    ]


def test_reference_hierarchy_carries_over(reference, port):
    """The reference's 2D hierarchy (a constant level and two cornered ones)
    goes through ``hierarchy_from_numpy``; its tables equal the port's own
    bit for bit, the float64 inverses cast to float32 agree to 1e-6
    relative, and so do the V-cycles on the two."""
    hr = hierarchy_from_numpy(spec_from_jax_hierarchy(reference[0].hierarchy), "cpu")
    hp = port[0].hierarchy
    assert [type(L.A).__name__ for L in hr.levels] == [
        "StencilOperator", "CorneredOperator", "CorneredOperator"]
    for a, c in zip(hr.levels, hp.levels):
        assert a.A.offsets == c.A.offsets and a.A.grid_shape == c.A.grid_shape
        assert torch.equal(a.A.values, c.A.values)
        if isinstance(a.A, tstencil.CorneredOperator):
            assert a.A.subsets == c.A.subsets
            assert torch.equal(a.A.table, c.A.table)
    assert_close(hr.coarse_inv, hp.coarse_inv, factor=1e-6)
    r = to_t(rand(SHAPE, 17))
    assert_close(tcycle.v_cycle(hr, r, None, x_zero=True),
                 tcycle.v_cycle(hp, r, None, x_zero=True), factor=1e-6)


def test_v_cycle_without_post_sweeps_prolongs_in_tensor_code(port, monkeypatch):
    """V(2,0) in 2D: the down-legs are K5 calls, the up-leg with no stages is
    the tensor ``prolong`` and add, as in the JAX package."""
    h = port[0].hierarchy
    calls = []
    real = tkernels.fused_stages_2d

    def counted(*a, **k):
        calls.append(k.get("ec") is not None)
        return real(*a, **k)

    monkeypatch.setattr(tkernels, "fused_stages_2d", counted)
    r = to_t(rand(SHAPE, 18))
    got = tcycle.v_cycle(h, r, None, pre=2, post=0, x_zero=True)
    assert calls == [False, False]

    def composed(level, b):
        L = h.levels[level]
        if level == h.num_levels - 1:
            return tcycle.coarse_solve(h, b)
        x = tsmoothers.smooth("rbgs", L.A, L.inv_diag, b, torch.zeros_like(b), 2, OMEGA)
        ec = composed(level + 1, restrict(tstencil.residual(L.A, b, x), h.transfer))
        return x + prolong(ec, L.grid_shape, h.transfer)

    assert_close(got, composed(0, r), factor=5e-6, what="V(2,0)")


# ---------------------------------------------------------------------------
# (c) K2 on a 2D grid: the lift to (1, ny, nx)
# ---------------------------------------------------------------------------


def test_df_update_lifts_a_2d_grid():
    """The 2D plain result equals the 3D plain result on the lifted operands
    bit for bit, the wrapper lifts, and the partials sum to ‖r_hi‖²."""
    from openmg_tpu_torch.ops import doublefloat as tdf

    offs2 = tpoisson.poisson_offsets(2)
    terms = tuple(tdf.pow2_terms(v) for v in (4.0, -1, -1, -1, -1))
    rng = np.random.default_rng(19)
    xh, xl = tdf.df_split(rng.standard_normal(SHAPE))
    bh, bl = tdf.df_split(rng.standard_normal(SHAPE))
    e = to_t(rand(SHAPE, 20) * 1e-3)
    plain2 = tkernels.df_update_residual_const_3d_plain(
        offs2, terms, xh, xl, e, bh, bl, emit_norm=True)
    lifted = tkernels.df_update_residual_const_3d_plain(
        tkernels._lift2d(offs2), terms, xh[None], xl[None], e[None], bh[None],
        bl[None], emit_norm=True)
    wrapped = tkernels.df_update_residual_const_3d(
        offs2, terms, xh, xl, e, bh, bl, emit_norm=True)
    for a, c, w in zip(plain2[:3], lifted[:3], wrapped[:3]):
        assert tuple(a.shape) == SHAPE and tuple(w.shape) == SHAPE
        assert torch.equal(a, c[0]) and torch.equal(w, a)
    r = plain2[2]
    want = float(torch.sum(r * r))
    assert float(torch.sum(plain2[3])) == pytest.approx(want, rel=1e-6)
    assert float(torch.sum(wrapped[3])) == pytest.approx(want, rel=1e-6)
    no_norm = tkernels.df_update_residual_const_3d(offs2, terms, xh, xl, e, bh, bl)
    assert len(no_norm) == 3 and torch.equal(no_norm[2], r)


# ---------------------------------------------------------------------------
# (d) K3 on a cornered 2D operator
# ---------------------------------------------------------------------------


def test_cornered_2d_pass_matches_the_smoothers(port):
    """K3's plain version on the lifted region table against the
    independent formulation of ``stencil.residual`` / ``smoothers``."""
    L = port[0].hierarchy.levels[1]
    op = L.A
    assert isinstance(op, tstencil.CorneredOperator) and op.ndim == 2
    assert tstencil.kernel_operands_ok(op, torch.zeros(op.grid_shape)) is None
    b, x = to_t(rand(L.grid_shape, 21)), to_t(rand(L.grid_shape, 22))
    corner = tfused._corner_info(op)
    V, O = op.values, op.offsets
    assert_close(tkernels.residual_const_3d(V, O, b, x, corner=corner),
                 tstencil.residual(op, b, x), factor=2e-6, scale=b)
    assert_close(tkernels.jacobi_const_3d(V, O, b, x, 2, OMEGA, corner=corner),
                 tsmoothers.jacobi(op, L.inv_diag, b, x, 2, OMEGA), factor=2e-6,
                 scale=b)
    assert_close(tkernels.rbgs_const_3d(V, O, b, x, 2, corner=corner),
                 tsmoothers.rbgs(op, L.inv_diag, b, x, 2), factor=2e-6, scale=b)
    red = tkernels.rbgs_half_sweep_const_3d(V, O, b, x, 0, corner=corner)
    mask = tsmoothers.red_mask(L.grid_shape)
    assert torch.equal(red[~mask], x[~mask])


# ---------------------------------------------------------------------------
# (e) the matrix and stencil-pair entry points in 2D; a 1D grid
# ---------------------------------------------------------------------------

# nx is neither a multiple of 128 nor 32 or 64: the JAX package takes its
# array path on every level (no Pallas trace)
ESHAPE = (24, 40)
EPARAMS = {"problemshape": ESHAPE, "gridlevels": 2, "max_dense_coarse": 256,
           "transfer": "linear", "residual_dtype": "doublefloat"}


@pytest.mark.parametrize("what", ["poisson matrix", "diffusion stencil pair"])
def test_2d_matrix_and_stencil_pair_match_reference(what):
    b = _rhs(ESHAPE, seed=23)
    kappa = 0.5 + np.random.default_rng(12).random(ESHAPE)
    if what == "poisson matrix":
        A = tpoisson.poisson(ESHAPE)
        xr, ri = jmg.mg_solve(A, b.ravel(), EPARAMS)
        xp, pi = tmg.mg_solve(A, b.ravel(), EPARAMS, device="cpu")
    else:
        A = tpoisson.diffusion(kappa)
        cfg = {k: v for k, v in EPARAMS.items() if k != "problemshape"}
        xr, ri = jmg.solve(jmg.diffusion_stencil(kappa), b, jmg.SolverConfig(**cfg))
        xp, pi = tmg.solve(tmg.diffusion_stencil(kappa), b, tmg.SolverConfig(**cfg),
                           device="cpu")
    assert pi["converged"] and pi["cycles"] == ri["cycles"]
    for a, r in zip(pi["residual_norms"], ri["residual_norms"]):
        bound = 1.5 if r < 1e-9 else 1.1
        assert r / bound <= a <= r * bound
    xp, xr = np.asarray(xp).ravel(), np.asarray(xr).ravel()
    assert np.linalg.norm(b.ravel() - A @ xp) < 1e-10 * 1.05
    lam_min = spla.eigsh(A.tocsc(), k=1, sigma=0, return_eigenvectors=False)[0]
    assert np.linalg.norm(xp - xr) <= 2e-10 / lam_min


def test_1d_grid_waits():
    """A 1D grid, refused before the 1D path was ported, sets up and solves
    (BASELINE config 1's hierarchy)."""
    b = tpoisson.rhs_random((64,), seed=3)
    solver = tmg.setup((64,), tmg.SolverConfig(gridlevels=2, max_dense_coarse=64),
                       device="cpu")
    x, info = solver.solve(b)
    assert info["converged"] and solver.hierarchy.num_levels == 2
    assert np.linalg.norm(b - tpoisson.poisson((64,)) @ x) < 1e-10 * 1.05


# ---------------------------------------------------------------------------
# (f) the device rule on the 2D path
# ---------------------------------------------------------------------------


def test_card_takes_every_2d_visit_to_the_kernel(port, monkeypatch):
    """Off the CPU (the device check patched as in ``test_torch_solve``) a 2D
    V-cycle still goes through the K5 entry point at every visit and never
    through the plain smoothers; a tensor that is not on the CPU goes for
    the kernel and never runs the plain version."""
    h = port[0].hierarchy
    r = to_t(rand(SHAPE, 24))
    want = tcycle.v_cycle(h, r, None, x_zero=True)
    visits = []
    real = tkernels.fused_stages_2d

    def counted(*a, **k):
        visits.append(tuple(a[2].shape))
        return real(*a, **k)

    monkeypatch.setattr(tkernels, "fused_stages_2d", counted)
    monkeypatch.setattr(tstencil, "_on_cpu", lambda t: False)
    for plain in ("jacobi", "rbgs"):
        monkeypatch.setattr(tsmoothers, plain,
                            lambda *a, **k: pytest.fail("plain smoother off the CPU"))
    got = tcycle.v_cycle(h, r, None, x_zero=True)
    assert visits == [(64, 128), (32, 64), (32, 64), (64, 128)]
    assert torch.equal(got, want)
    # smooth on a cornered 2D operator goes to K5, the residual to K3
    L = h.levels[1]
    b, x = to_t(rand(L.grid_shape, 25)), to_t(rand(L.grid_shape, 26))
    passes = []
    real_pass = tkernels._half_sweep

    def counted_pass(*a, **k):
        passes.append(k["mode"])
        return real_pass(*a, **k)

    monkeypatch.setattr(tkernels, "_half_sweep", counted_pass)
    tsmoothers.smooth("rbgs", L.A, L.inv_diag, b, x, 2, OMEGA)
    assert visits[-1] == L.grid_shape and not passes
    tstencil.residual(L.A, b, x)
    assert passes == ["residual"]
    with pytest.raises(NotImplementedError, match="float32"):
        tsmoothers.smooth("rbgs", L.A, L.inv_diag, b.double(), x.double(), 2, OMEGA)

    called = []
    monkeypatch.setattr(tkernels, "fused_stages_2d_plain",
                        lambda *a, **k: called.append(1))
    meta = torch.empty(SHAPE, dtype=torch.float32, device="meta")
    vals = torch.empty((5,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        real(vals, tpoisson.poisson_offsets(2), meta, meta, RB4)
    assert not called


def test_cpu_calls_do_not_count_as_launches(port):
    L = port[0].hierarchy.levels[0]
    b = to_t(rand(SHAPE, 27))
    before = tkernels.LAUNCHES_K5
    tkernels.fused_stages_2d(L.A.values, L.A.offsets, b, None, RB4,
                             emit_residual=True)
    assert tkernels.LAUNCHES_K5 == before
