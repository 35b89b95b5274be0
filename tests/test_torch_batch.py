"""The batched forms K1b, K2b and K5b (K right-hand sides in one launch,
the JAX package's kernels under ``jax.vmap``) and ``Solver.solve_many`` on
them, on the CPU: their plain versions against ``jax.vmap`` of the
reference's Pallas kernels in interpret mode and against the port's scalar
plain versions member by member.

Tolerances: K1b against the reference 2e-6·max|ref| (a restricted residual:
2e-6·max|b|), ``tests/test_torch_fused.py``'s, for the same reason (float32
sums in another order); K5b on a constant level likewise; K2b bit for bit,
as ``tests/test_torch_df.py`` holds K2, its partials per member within 1e-6
relative of the reference's sum of ``r_hi²``.  Against the port's scalar
plain versions every batched output is bit-equal, member by member: the
batched plain versions run the scalar ones on each member.

Each reference trace in interpret mode costs about two seconds, so each
kernel is traced once, at K = 2 on the smallest shape the reference's
kernel takes; the reference ``solve_many`` at (8, 8, 16) runs its array
path (no Pallas trace).
"""

import numpy as np
import pytest
import torch

import jax

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.models.poisson import poisson_offsets
from openmg_tpu.ops import fused as jfused
from openmg_tpu.ops import kernels as jkernels
from openmg_tpu.ops.transfer import TRANSFERS as JTRANSFERS
from openmg_tpu_torch.ops import doublefloat as tdf
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import kernels as tkernels
from openmg_tpu_torch.ops.stencil import CorneredOperator, StencilOperator
from openmg_tpu_torch.ops.transfer import TRANSFERS as TTRANSFERS

from _torch_parity import assert_close, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

K = 2
OMEGA = 2.0 / 3.0
RB4 = (("rb", 0), ("rb", 1)) * 2  # the main path's two red/black sweeps
SHAPE3 = (8, 16, 128)  # the smallest 3D grid the reference's K1 takes
SHAPE2 = (32, 128)
MAIN_KW = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat")


def _poisson(ndim):
    offs = tuple(tuple(o) for o in poisson_offsets(ndim))
    vals = np.array([2.0 * ndim] + [-1.0] * (2 * ndim), dtype=np.float32)
    return offs, vals


def _stack(shape, seed, scale=1.0):
    return np.stack([rand(shape, seed + m) * np.float32(scale) for m in range(K)])


# ---------------------------------------------------------------------------
# K1b: the 3D level visit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def k1b():
    offs, vals = _poisson(3)
    b = _stack(SHAPE3, 40)
    tr_j, tr_t = JTRANSFERS["linear"], TTRANSFERS["linear"]
    ref = jax.vmap(lambda bb: jfused.fused_stages_const_3d(
        to_j(vals), offs, bb, None, RB4, emit_residual=True,
        restrict_transfer=tr_j))(to_j(b))
    got = tfused.fused_stages_const_3d_batch(
        to_t(vals), offs, to_t(b), None, RB4, emit_residual=True,
        restrict_transfer=tr_t)
    return offs, vals, b, tr_t, ref, got


def test_k1b_plain_matches_vmapped_reference(k1b):
    _, _, b, _, ref, got = k1b
    assert tuple(got[0].shape) == (K,) + SHAPE3
    assert tuple(got[1].shape) == (K,) + tuple(s // 2 for s in SHAPE3)
    assert_close(got[0], ref[0], what="x")
    assert_close(got[1], ref[1], scale=b, what="bc")


def test_k1b_plain_is_the_scalar_plain_member_by_member(k1b):
    offs, vals, b, tr_t, _, got = k1b
    for m in range(K):
        one = tfused.fused_stages_const_3d_plain(
            to_t(vals), offs, to_t(b[m]), None, RB4, emit_residual=True,
            restrict_transfer=tr_t)
        assert torch.equal(got[0][m], one[0]) and torch.equal(got[1][m], one[1])


@pytest.mark.parametrize("mode", ["up-leg", "residual + restrict", "from x"])
def test_k1b_modes_are_the_scalar_dispatch_member_by_member(mode):
    """The other visits of a cycle (and a visit deeper than one launch,
    which splits into the same chunks) on a cornered level: each member as
    the scalar dispatcher computes it."""
    h = tmg.setup(SHAPE3, tmg.SolverConfig(gridlevels=3, max_dense_coarse=2048,
                                           **MAIN_KW), device="cpu").hierarchy
    op, tr = h.levels[1].A, h.transfer
    assert isinstance(op, CorneredOperator)
    shape = op.grid_shape
    b, x = to_t(_stack(shape, 50)), to_t(_stack(shape, 52))
    ec = to_t(_stack(tuple(s // 2 for s in shape), 54))
    kw = {
        "up-leg": dict(stages=RB4 * 2, ec=ec, prolong_transfer=tr),
        "residual + restrict": dict(stages=(), emit_residual=True,
                                    restrict_transfer=tr, emit_x=False),
        "from x": dict(stages=RB4, emit_residual=True, restrict_transfer=tr),
    }[mode]
    got = tfused.fused_stages_const_3d_batch(op.values, op.offsets, b, x, **kw)
    got = got if isinstance(got, tuple) else (got,)
    for m in range(K):
        mkw = dict(kw, ec=ec[m]) if "ec" in kw else kw
        one = tfused.fused_stages_const_3d(op.values, op.offsets, b[m], x[m], **mkw)
        one = one if isinstance(one, tuple) else (one,)
        assert all(torch.equal(g[m], o) for g, o in zip(got, one))


# ---------------------------------------------------------------------------
# K2b: the double-float outer step
# ---------------------------------------------------------------------------

K2_SHAPE = (4, 8, 128)


@pytest.mark.parametrize("ndim", [3, 2])
def test_k2b_plain_matches_vmapped_reference(ndim):
    shape = K2_SHAPE if ndim == 3 else K2_SHAPE[1:]
    offs, vals = _poisson(ndim)
    terms = tuple(tdf.pow2_terms(float(v)) for v in vals)
    rng = np.random.default_rng(9)
    bh, bl = tdf.df_split(rng.standard_normal((K,) + shape))
    xh, xl = tdf.df_split(rng.standard_normal((K,) + shape))
    e = torch.from_numpy(_stack(shape, 60, 1e-3))
    ref = jax.vmap(lambda a, b_, c, d, f: jkernels.df_update_residual_const_3d(
        offs, terms, a, b_, c, d, f, emit_norm=True))(
        *(to_j(to_n(t)) for t in (xh, xl, e, bh, bl)))
    got = tkernels.df_update_residual_batch(offs, terms, xh, xl, e, bh, bl,
                                            emit_norm=True)
    for name, g, r in zip(("x_hi", "x_lo", "r_hi"), got, ref):
        np.testing.assert_array_equal(to_n(g), to_n(r), err_msg=name)
    norms = tkernels.df_norms(got[3])
    assert tuple(norms.shape) == (K,)
    for m in range(K):
        want = float(np.sum(to_n(ref[2][m]).astype(np.float64) ** 2))
        assert abs(float(norms[m]) ** 2 - want) <= 1e-6 * want
        one = tkernels.df_update_residual_const_3d(
            offs, terms, xh[m], xl[m], e[m], bh[m], bl[m], emit_norm=True)
        assert all(torch.equal(g[m], o) for g, o in zip(got, one))
        # the member's norm by the scalar step's own call
        assert torch.equal(norms[m], torch.sqrt(torch.sum(one[3])))


# ---------------------------------------------------------------------------
# K5b: the 2D level visit
# ---------------------------------------------------------------------------


def test_k5b_plain_matches_vmapped_reference():
    offs, vals = _poisson(2)
    b = _stack(SHAPE2, 70)
    tr_j, tr_t = JTRANSFERS["linear"], TTRANSFERS["linear"]
    ref = jax.vmap(lambda bb: jkernels.fused_stages_2d(
        to_j(vals), offs, bb, None, RB4, emit_residual=True,
        restrict_transfer=tr_j))(to_j(b))
    got = tkernels.fused_stages_2d_batch(
        to_t(vals), offs, to_t(b), None, RB4, emit_residual=True,
        restrict_transfer=tr_t)
    assert tuple(got[1].shape) == (K,) + tuple(s // 2 for s in SHAPE2)
    assert_close(got[0], ref[0], what="x")
    assert_close(got[1], ref[1], scale=b, what="bc")
    for m in range(K):
        one = tkernels.fused_stages_2d(
            to_t(vals), offs, to_t(b[m]), None, RB4, emit_residual=True,
            restrict_transfer=tr_t)
        assert torch.equal(got[0][m], one[0]) and torch.equal(got[1][m], one[1])


# ---------------------------------------------------------------------------
# solve_many on the batched forms
# ---------------------------------------------------------------------------

MANY_SHAPE = (8, 8, 16)


def _many_cfg(pkg):
    return pkg.SolverConfig(gridlevels=3, max_dense_coarse=64, cycles=60,
                            **MAIN_KW)


def _calls(monkeypatch, module, name):
    """Counts the calls of ``module.name`` (a list that grows by one a
    call)."""
    calls = []
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_solve_many_runs_the_batch_through_the_batched_forms(monkeypatch):
    """The main path's settings, one member at 1e-3 scale: every member's
    pair and norm history bit-equal to its scalar solve, the cycles equal
    to the reference's ``solve_many``; one K1b call a level visit and one
    K2b call a step for the whole batch, no scalar K1 or K2 call."""
    rhs = [np.random.default_rng(s).standard_normal(MANY_SHAPE) for s in (1, 2, 3)]
    rhs[1] = rhs[1] * 1e-3
    _, ir = jmg.setup(MANY_SHAPE, _many_cfg(jmg)).solve_many(rhs)
    solver = tmg.setup(MANY_SHAPE, _many_cfg(tmg), device="cpu")
    scalar = [solver.solve(b) for b in rhs]
    k1b = _calls(monkeypatch, tfused, "fused_stages_const_3d_batch")
    k2b = _calls(monkeypatch, tkernels, "df_update_residual_batch")
    k1 = _calls(monkeypatch, tfused, "fused_stages_const_3d")
    k2 = _calls(monkeypatch, tkernels, "df_update_residual_const_3d")
    xs, info = solver.solve_many(rhs)
    steps = max(info["cycles"])
    assert info["cycles"] == ir["cycles"]
    assert info["cycles"][1] < info["cycles"][0]
    assert info["host_reads"] == steps + 1
    visits = 2 * (solver.hierarchy.num_levels - 1)
    assert (len(k1b), len(k2b), len(k1), len(k2)) == (visits * steps, steps, 0, 0)
    for k, (xk, ik) in enumerate(scalar):
        np.testing.assert_array_equal(xs[k], xk)
        assert info["residual_norms"][k] == ik["residual_norms"]
        assert info["final_norm"][k] == ik["final_norm"] and info["converged"][k]


def test_batched_wrappers_count_nothing_on_the_cpu():
    before = (tfused.LAUNCHES_BATCH, tkernels.LAUNCHES_K2_BATCH,
              tkernels.LAUNCHES_K5_BATCH)
    offs3, vals3 = _poisson(3)
    offs2, vals2 = _poisson(2)
    b3, b2 = to_t(_stack((4, 4, 8), 80)), to_t(_stack((8, 8), 82))
    tfused.fused_stages_const_3d_batch(to_t(vals3), offs3, b3, None, RB4)
    tkernels.fused_stages_2d_batch(to_t(vals2), offs2, b2, None, RB4)
    terms = tuple(tdf.pow2_terms(float(v)) for v in vals3)
    tkernels.df_update_residual_batch(offs3, terms, b3, b3, b3, b3, b3,
                                      emit_norm=True)
    assert (tfused.LAUNCHES_BATCH, tkernels.LAUNCHES_K2_BATCH,
            tkernels.LAUNCHES_K5_BATCH) == before


def test_batched_wrappers_refuse_before_launching():
    """Malformed batches are refused by the wrappers' checks, which run
    before a kernel is built or launched (so here, on CPU tensors)."""
    offs3, vals3 = _poisson(3)
    offs2, vals2 = _poisson(2)
    terms = tuple(tdf.pow2_terms(float(v)) for v in vals3)
    v3, v2 = to_t(vals3), to_t(vals2)
    b = to_t(_stack((4, 4, 8), 90))
    tr = TTRANSFERS["linear"]
    with pytest.raises(ValueError, match="4D"):
        tfused._fused_stages_cuda(v3, offs3, b[0], None, RB4, False, None, None,
                                  None, None, True, batch=True)
    with pytest.raises(ValueError, match="halos"):
        tfused._fused_stages_cuda(v3, offs3, b, None, RB4, False, None, None,
                                  None, None, True, halos=((0, 0), None, None, None),
                                  batch=True)
    with pytest.raises(ValueError, match="ec"):
        tfused._fused_stages_cuda(v3, offs3, b, b, RB4, False, None, None,
                                  b[:, ::2, ::2, ::2].contiguous()[:1], tr, True,
                                  batch=True)
    with pytest.raises(ValueError, match="batches"):
        tkernels._df_update_residual_cuda(offs3, terms, b[0], b[0], b[0], b[0],
                                          b[0], True, batch=True)
    with pytest.raises(ValueError, match="shape"):
        tkernels._fused2d_cuda(v2, offs2, b[0, 0], None, RB4, corner=None,
                               emit_residual=False, restrict_transfer=None,
                               ec=None, prolong_transfer=None, batch=True)
    # the public forms: a grid of the operator's dimension, not a batch
    with pytest.raises(ValueError, match=r"\(K, \*grid\)"):
        tfused.fused_stages_const_3d_batch(v3, offs3, b[0], None, RB4)
    with pytest.raises(ValueError, match="3D grids"):
        tfused.fused_stages_const_3d_batch(v2, offs2, b[0], None, RB4)
    with pytest.raises(ValueError, match=r"\(K, \*grid\)"):
        tkernels.fused_stages_2d_batch(v2, offs2, b[0, 0], None, RB4)
    with pytest.raises(ValueError, match="operand"):
        tkernels.df_update_residual_batch(offs3, terms, b, b, b[:1], b, b)


def test_a_2d_batch_goes_to_k5b_not_k1(monkeypatch):
    """A batch of 2D planes has the shape of a 3D grid: the entry points
    decide by the operator's dimension, so it reaches K5b."""
    offs, vals = _poisson(2)
    op = StencilOperator(None, offs, to_t(vals), (8, 16))
    b = to_t(_stack((8, 16), 95))
    k5b = _calls(monkeypatch, tkernels, "fused_stages_2d_batch")

    def no_3d(*a, **kw):
        raise AssertionError("a 2D batch reached the 3D kernel")

    monkeypatch.setattr(tfused, "fused_stages_const_3d", no_3d)
    monkeypatch.setattr(tfused, "fused_stages_const_3d_batch", no_3d)
    x, bc = tfused.presmooth_restrict_fused("rbgs", op, b, None, 2, OMEGA,
                                            TTRANSFERS["linear"])
    assert len(k5b) == 1 and tuple(bc.shape) == (K, 4, 8)
    assert tfused.residual_restrict_fused(op, b, x, TTRANSFERS["linear"]) is None
