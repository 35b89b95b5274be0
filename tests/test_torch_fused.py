"""The fused level-visit function: the port's plain PyTorch version
(``openmg_tpu_torch.ops.fused``, on CPU tensors) against the JAX package's
Pallas kernel in interpret mode, for every entry point on a constant and on
a cornered operator; and against the port's own smoother + residual +
restrict composition on shapes the JAX kernel does not admit.

Tolerance 2e-6·max|ref| absolute: float32 with another order of summation
and fused multiply-adds on one side, and the interior rows' multiply by
1/diag against the region rows' divide by diag.

Each Pallas trace in interpret mode costs seconds per stage on a cornered
operator, so the cornered cases run one sweep; the constant ones run the
main path's two (and three Jacobi steps).  On the cornered operator two
reference traces each serve two tests: the zero-start pre-smoothing with its
residual also gives the restricted residual (the reference's own
``restrict`` of it), and one red-black sweep from ``x + P·ec`` (the
reference's own ``prolong``) is the reference of both ``smooth_fused`` and
``prolong_smooth_fused``.  The reference's in-kernel transfers are held on
the constant operator, its in-kernel restriction on the cornered one by
``residual_restrict_fused``, and both on cornered levels by the V-cycle of
``test_torch_solve.py``.
"""

from functools import cached_property

import numpy as np
import pytest
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.ops import fused as jfused
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import smoothers as tsm
from openmg_tpu_torch.ops import stencil as tst
from openmg_tpu_torch.ops import transfer as ttr

from _torch_parity import assert_close, port_op, rand, to_j, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

OMEGA = 2.0 / 3.0
LIN_KW = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat")


class Case:
    """One operator in both packages with shared random inputs."""

    def __init__(self, Lj, transfer_name, sweeps):
        self.Aj = Lj.A
        self.At = port_op(Lj.A)
        from openmg_tpu.ops.transfer import TRANSFERS as JT

        self.trj = JT[transfer_name]
        self.trt = ttr.TRANSFERS[transfer_name]
        self.shape = tuple(self.Aj.grid_shape)
        self.b = rand(self.shape, 1)
        self.x = rand(self.shape, 2)
        self.ec = rand(tuple(s // 2 for s in self.shape), 3)
        self.sweeps = sweeps
        self.cornered = not self.Aj.is_constant

    @cached_property
    def ref_presmooth_residual(self):
        """Reference ``(x, r)`` of the zero-start pre-smoothing."""
        ref = jfused.presmooth_residual_fused(
            "rbgs", self.Aj, to_j(self.b), self.sweeps, OMEGA
        )
        assert ref is not None, "the reference should take its Pallas path here"
        return ref

    @cached_property
    def x_plus_pec(self):
        """``x + P·ec`` by the reference's own prolongation, as numpy."""
        from openmg_tpu.ops.transfer import prolong as jprolong

        return np.asarray(
            to_j(self.x) + jprolong(to_j(self.ec), self.shape, self.trj)
        )

    @cached_property
    def ref_smooth_from_x_plus_pec(self):
        """Reference red-black ``sweeps`` from ``x + P·ec``."""
        ref = jfused.smooth_fused(
            "rbgs", self.Aj, to_j(self.b), to_j(self.x_plus_pec), self.sweeps, OMEGA
        )
        assert ref is not None
        return ref


@pytest.fixture(scope="module")
def const_case():
    h = jmg.setup((8, 16, 128), jmg.SolverConfig(gridlevels=2, max_dense_coarse=2048, **LIN_KW)).hierarchy
    assert h.levels[0].A.is_constant
    return Case(h.levels[0], "linear", 2)


@pytest.fixture(scope="module")
def cornered_case():
    from openmg_tpu.ops.stencil import CorneredOperator

    h = jmg.setup((16, 32, 128), jmg.SolverConfig(**LIN_KW)).hierarchy
    L = h.levels[1]
    assert isinstance(L.A, CorneredOperator) and L.A.grid_shape == (8, 16, 64)
    return Case(L, "linear", 1)


@pytest.fixture(params=["const", "cornered"])
def case(request, const_case, cornered_case):
    return const_case if request.param == "const" else cornered_case


def test_presmooth_restrict_zero_start(case):
    c = case
    if c.cornered:
        from openmg_tpu.ops.transfer import restrict as jrestrict

        xr, rr = c.ref_presmooth_residual
        ref = xr, jrestrict(rr, c.trj)
    else:
        ref = jfused.presmooth_restrict_fused(
            "rbgs", c.Aj, to_j(c.b), None, c.sweeps, OMEGA, c.trj
        )
        assert ref is not None, "the reference should take its Pallas path here"
    got = tfused.presmooth_restrict_fused(
        "rbgs", c.At, to_t(c.b), None, c.sweeps, OMEGA, c.trt
    )
    assert got[1].shape == tuple(s // 2 for s in c.shape)
    assert_close(got[0], ref[0], what="x")
    assert_close(got[1], ref[1], what="bc")


def test_prolong_smooth(case):
    c = case
    if c.cornered:
        ref = c.ref_smooth_from_x_plus_pec
    else:
        ref = jfused.prolong_smooth_fused(
            "rbgs", c.Aj, to_j(c.b), to_j(c.x), to_j(c.ec), c.sweeps, OMEGA, c.trj
        )
        assert ref is not None
    got = tfused.prolong_smooth_fused(
        "rbgs", c.At, to_t(c.b), to_t(c.x), to_t(c.ec), c.sweeps, OMEGA, c.trt
    )
    assert_close(got, ref, what="x")


@pytest.mark.parametrize("name,iters", [("jacobi", 3), ("rbgs", 2)])
def test_smooth_fused_const(const_case, name, iters):
    c = const_case
    ref = jfused.smooth_fused(name, c.Aj, to_j(c.b), to_j(c.x), iters, OMEGA)
    assert ref is not None
    got = tfused.smooth_fused(name, c.At, to_t(c.b), to_t(c.x), iters, OMEGA)
    assert_close(got, ref, what=name)


@pytest.mark.parametrize("name,iters", [("jacobi", 2), ("rbgs", 1)])
def test_smooth_fused_cornered(cornered_case, name, iters):
    c = cornered_case
    if name == "rbgs":
        assert iters == c.sweeps
        x, ref = c.x_plus_pec, c.ref_smooth_from_x_plus_pec
    else:
        x = c.x
        ref = jfused.smooth_fused(name, c.Aj, to_j(c.b), to_j(x), iters, OMEGA)
        assert ref is not None
    got = tfused.smooth_fused(name, c.At, to_t(c.b), to_t(x), iters, OMEGA)
    assert_close(got, ref, what=name)


def test_presmooth_residual(case):
    c = case
    ref = c.ref_presmooth_residual
    got = tfused.presmooth_residual_fused("rbgs", c.At, to_t(c.b), c.sweeps, OMEGA)
    assert_close(got[0], ref[0], what="x")
    assert_close(got[1], ref[1], what="r")


def test_residual_restrict(case):
    c = case
    ref = jfused.residual_restrict_fused(c.Aj, to_j(c.b), to_j(c.x), c.trj)
    assert ref is not None
    got = tfused.residual_restrict_fused(c.At, to_t(c.b), to_t(c.x), c.trt)
    assert_close(got, ref, what="bc")


# ---------------------------------------------------------------------------
# against the port's own composition, on shapes the JAX kernel refuses
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def odd_lane_levels():
    h = tmg.setup(
        (12, 20, 40), tmg.SolverConfig(gridlevels=3, max_dense_coarse=256, **LIN_KW),
        device="cpu",
    ).hierarchy
    assert isinstance(h.levels[1].A, tst.CorneredOperator)
    assert h.levels[1].grid_shape == (6, 10, 20)
    return h


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name", ["jacobi", "rbgs"])
def test_plain_matches_composition(odd_lane_levels, level, name):
    h = odd_lane_levels
    L, tr = h.levels[level], h.transfer
    shape = L.grid_shape
    b, x = to_t(rand(shape, 4)), to_t(rand(shape, 5))
    ec = to_t(rand(tuple(s // 2 for s in shape), 6))
    zero = torch.zeros_like(b)

    xs = tsm.smooth(name, L.A, L.inv_diag, b, zero, 2, OMEGA)
    got = tfused.presmooth_restrict_fused(name, L.A, b, None, 2, OMEGA, tr)
    assert_close(got[0], xs, what="presmooth x")
    assert_close(got[1], ttr.restrict(tst.residual(L.A, b, xs), tr), what="bc", scale=b)

    got = tfused.presmooth_residual_fused(name, L.A, b, 2, OMEGA)
    assert_close(got[1], tst.residual(L.A, b, xs), what="r", scale=b)

    want = tsm.smooth(
        name, L.A, L.inv_diag, b, x + ttr.prolong(ec, shape, tr), 2, OMEGA
    )
    got = tfused.prolong_smooth_fused(name, L.A, b, x, ec, 2, OMEGA, tr)
    assert_close(got, want, what="prolong+smooth")

    got = tfused.residual_restrict_fused(L.A, b, x, tr)
    assert_close(got, ttr.restrict(tst.residual(L.A, b, x), tr), what="resid+restrict")

    got = tfused.smooth_fused(name, L.A, b, x, 3, OMEGA)
    assert_close(got, tsm.smooth(name, L.A, L.inv_diag, b, x, 3, OMEGA), what="smooth")


def test_aggregate_transfer_composition(odd_lane_levels):
    L = odd_lane_levels.levels[0]
    tr = ttr.AGGREGATE
    shape = L.grid_shape
    b, x = to_t(rand(shape, 7)), to_t(rand(shape, 8))
    ec = to_t(rand(tuple(s // 2 for s in shape), 9))
    got = tfused.residual_restrict_fused(L.A, b, x, tr)
    assert_close(got, ttr.restrict(tst.residual(L.A, b, x), tr))
    got = tfused.prolong_smooth_fused("rbgs", L.A, b, x, ec, 1, OMEGA, tr)
    want = tsm.smooth("rbgs", L.A, L.inv_diag, b, x + ttr.prolong(ec, shape, tr), 1, OMEGA)
    assert_close(got, want)


def test_entry_points_decline_only_what_the_kernel_cannot_take(odd_lane_levels):
    L, tr = odd_lane_levels.levels[0], odd_lane_levels.transfer
    b = to_t(rand(L.grid_shape, 10))
    assert tfused.stages_for("chebyshev", 2, OMEGA) is None
    assert tfused.stages_for("rbgs", 2, OMEGA) == (("rb", 0), ("rb", 1)) * 2
    assert tfused.smooth_fused("chebyshev", L.A, b, b, 2, OMEGA) is None
    assert tfused.smooth_fused("rbgs", L.A, b.double(), b.double(), 2, OMEGA) is None
    assert tfused.smooth_fused("rbgs", L.A, b[0], b[0], 2, OMEGA) is None
    # an odd dimension with a transfer
    op = tst.StencilOperator(None, L.A.offsets, L.A.values, (5, 20, 40))
    b5 = to_t(rand((5, 20, 40), 11))
    assert tfused.presmooth_restrict_fused("rbgs", op, b5, None, 2, OMEGA, tr) is None
    assert tfused.residual_restrict_fused(op, b5, b5, tr) is None
    assert tfused.prolong_smooth_fused("rbgs", op, b5, b5, b5, 2, OMEGA, tr) is None
    # ... but smoothing alone takes it: no lane rule
    assert tfused.smooth_fused("rbgs", op, b5, b5, 1, OMEGA) is not None
    with pytest.raises(ValueError):
        tfused.fused_stages_const_3d(
            L.A.values, L.A.offsets, b, b, (("rb", 0),), emit_x=False
        )
    # a call that would launch nothing is refused, not counted
    with pytest.raises(ValueError, match="nothing to do"):
        tfused.fused_stages_const_3d(L.A.values, L.A.offsets, b, b, ())


def test_cpu_calls_do_not_count_as_launches(odd_lane_levels):
    L = odd_lane_levels.levels[0]
    b = to_t(rand(L.grid_shape, 12))
    before = tfused.LAUNCHES
    tfused.smooth_fused("rbgs", L.A, b, b, 1, OMEGA)
    assert tfused.LAUNCHES == before


# ---------------------------------------------------------------------------
# the wrapper's host-side logic: depth split and argument checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_stages,extra", [(4, 2), (5, 1), (5, 2), (6, 0), (7, 0), (10, 2), (14, 0), (50, 0)])
def test_depth_chunks(n_stages, extra):
    """A visit of depth d = stages + extra is cut into ⌈d / MAX_DEPTH⌉ chunks
    of at most MAX_DEPTH; the stages keep their order and only the last chunk
    carries the residual levels."""
    stages = tuple(("jacobi", 0.5 + 0.01 * k) for k in range(n_stages))
    chunks = tfused.depth_chunks(stages, extra, tfused.MAX_DEPTH)
    depth = n_stages + extra
    assert len(chunks) == -(-depth // tfused.MAX_DEPTH)
    assert sum(chunks, ()) == stages
    assert all(len(c) <= tfused.MAX_DEPTH for c in chunks[:-1])
    assert len(chunks[-1]) + extra <= tfused.MAX_DEPTH


def test_max_depth_covers_the_main_path():
    # V(2,2) red/black with residual and restriction, and a 6-Jacobi chunk
    assert tfused.MAX_DEPTH >= len(tfused.stages_for("rbgs", 2, OMEGA)) + 2
    assert tfused.MAX_DEPTH >= 6


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name,iters", [("jacobi", 7), ("rbgs", 4)])
def test_split_visit_equals_whole(odd_lane_levels, level, name, iters):
    """On the CPU the dispatcher runs a deep visit chunk by chunk, as the
    card does; the plain version run whole gives the same bits."""
    h = odd_lane_levels
    L, tr = h.levels[level], h.transfer
    shape = L.grid_shape
    b, x = to_t(rand(shape, 21)), to_t(rand(shape, 22))
    ec = to_t(rand(tuple(s // 2 for s in shape), 23))
    stages = tfused.stages_for(name, iters, OMEGA)
    assert len(stages) + 2 > tfused.MAX_DEPTH
    corner = tfused._corner_info(L.A)
    kw = dict(corner=corner, restrict_transfer=tr, ec=ec, prolong_transfer=tr)
    got = tfused.fused_stages_const_3d(L.A.values, L.A.offsets, b, x, stages,
                                       emit_residual=True, **kw)
    want = tfused.fused_stages_const_3d_plain(L.A.values, L.A.offsets, b, x, stages,
                                              emit_residual=True, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = tfused.fused_stages_const_3d(L.A.values, L.A.offsets, b, None, stages,
                                       corner=corner)
    want = tfused.fused_stages_const_3d_plain(L.A.values, L.A.offsets, b, None,
                                              stages, corner=corner)
    assert torch.equal(got, want)


def test_kernel_wrapper_refuses_before_launching(odd_lane_levels):
    """What one launch does not take is refused by the wrapper's checks, which
    run before the kernel is built or launched (so here, on CPU tensors)."""
    L, tr = odd_lane_levels.levels[0], odd_lane_levels.transfer
    V, O = L.A.values, L.A.offsets
    shape = L.grid_shape
    b = to_t(rand(shape, 24))
    ec = to_t(rand(tuple(s // 2 for s in shape), 25))
    call = tfused._fused_stages_cuda
    deep = tfused.stages_for("jacobi", tfused.MAX_DEPTH + 1, OMEGA)
    with pytest.raises(ValueError, match="depth"):
        call(V, O, b, None, deep, False, None, None, None, None, True)
    with pytest.raises(ValueError, match="depth"):
        call(V, O, b, None, deep[:tfused.MAX_DEPTH - 1], True, None, tr, None, None, True)
    with pytest.raises(ValueError, match="3D"):
        call(V, O, b[0], None, deep[:1], False, None, None, None, None, True)
    with pytest.raises(ValueError, match="float32"):
        call(V.double(), O, b.double(), None, deep[:1], False, None, None, None, None, True)
    with pytest.raises(ValueError, match="shape"):
        call(V, O, b, b[:, :, :-2].contiguous(), deep[:1], False, None, None, None, None, True)
    with pytest.raises(ValueError, match="contiguous"):
        call(V, O, b.transpose(1, 2), None, deep[:1], False, None, None, None, None, True)
    with pytest.raises(ValueError, match="ec needs prolong_transfer"):
        call(V, O, b, b, deep[:1], False, None, None, ec, None, True)
    with pytest.raises(ValueError, match="radius-1"):
        call(V, O[:-1] + ((0, 0, 2),), b, None, deep[:1], False, None, None, None, None, True)
    odd = to_t(rand((5, 20, 40), 26))
    with pytest.raises(ValueError, match="even dims"):
        call(V, O, odd, None, deep[:1], True, None, tr, None, None, True)
