"""The stencil-pair slice of the port on the CPU against the JAX package:
the per-pass kernels' plain versions against the Pallas kernels in
interpret mode, the host-side generators and Dekker products bit for bit,
``build_hierarchy`` bit for bit, and the variable-coefficient diffusion
solve, the V-cycle and the matrix ``mg_solve`` as a whole.

Inputs come from numpy seeds and go to both packages.  Reference calls that
trace a Pallas kernel (seven, all at (8, 8, 128) or its 2D lift) and the
reference solves sit in module-scoped fixtures.
"""

import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.core import hierarchy as jhier
from openmg_tpu.models import poisson as jpoisson
from openmg_tpu.ops import doublefloat as jdf
from openmg_tpu.ops import kernels as jkernels
from openmg_tpu.ops.transfer import TRANSFERS as JTRANSFERS
from openmg_tpu_torch.core import cycle as tcycle
from openmg_tpu_torch.core import hierarchy as thier
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.ops import doublefloat as tdf
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import kernels as tkernels
from openmg_tpu_torch.ops import smoothers as tsmoothers
from openmg_tpu_torch.ops import stencil as tstencil
from openmg_tpu_torch.ops.transfer import TRANSFERS as TTRANSFERS
from openmg_tpu_torch.utils.convert import hierarchy_from_numpy

from _torch_parity import assert_close, rand, spec_from_jax_hierarchy, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

KSHAPE = (8, 8, 128)  # the shape of tests/test_kernels.py
OMEGA = 2.0 / 3.0


def _medium(shape, seed=12):
    return 0.5 + np.random.default_rng(seed).random(shape)


# ---------------------------------------------------------------------------
# (a) the per-pass kernels: plain versions against Pallas in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pass_data():
    offsets = tpoisson.poisson_offsets(3)
    values = np.asarray([6.0] + [-1.0] * 6, dtype=np.float32)
    _, coeffs = tpoisson.diffusion_stencil(_medium(KSHAPE))
    return dict(
        offsets=offsets, values=values, coeffs=coeffs.astype(np.float32),
        b=rand(KSHAPE, 0), x=rand(KSHAPE, 1),
    )


@pytest.fixture(scope="module")
def pass_reference(pass_data):
    """Six traced reference calls: Jacobi ×2, red/black ×2 and the residual,
    for the constant and the varying operator."""
    d = pass_data
    O, b, x = d["offsets"], to_j(d["b"]), to_j(d["x"])
    v, c = to_j(d["values"]), to_j(d["coeffs"])
    return {
        ("const", "jacobi"): to_n(jkernels.jacobi_const_3d(v, O, b, x, 2, OMEGA)),
        ("const", "rbgs"): to_n(jkernels.rbgs_const_3d(v, O, b, x, 2)),
        ("const", "residual"): to_n(jkernels.residual_const_3d(v, O, b, x)),
        ("vary", "jacobi"): to_n(jkernels.jacobi_vary_3d(c, O, b, x, 2, OMEGA)),
        ("vary", "rbgs"): to_n(jkernels.rbgs_vary_3d(c, O, b, x, 2)),
        ("vary", "residual"): to_n(jkernels.residual_vary_3d(c, O, b, x)),
    }


@pytest.mark.parametrize("mode", ["jacobi", "rbgs", "residual"])
@pytest.mark.parametrize("kind", ["const", "vary"])
def test_pass_entry_points_match_reference_kernels(pass_data, pass_reference, kind, mode):
    """2e-6·max|ref| (max|b| for the residual) holds for both kinds: the
    sums run in the same order and only the last bits differ.  (The JAX
    package's own tests allow 2e-5 for the varying kernel.)"""
    d = pass_data
    O, b, x = d["offsets"], to_t(d["b"]), to_t(d["x"])
    first = to_t(d["values"] if kind == "const" else d["coeffs"])
    suffix = "const_3d" if kind == "const" else "vary_3d"
    if mode == "jacobi":
        got = getattr(tkernels, f"jacobi_{suffix}")(first, O, b, x, 2, OMEGA)
    elif mode == "rbgs":
        got = getattr(tkernels, f"rbgs_{suffix}")(first, O, b, x, 2)
    else:
        got = getattr(tkernels, f"residual_{suffix}")(first, O, b, x)
    ref = pass_reference[(kind, mode)]
    assert_close(got, ref, factor=2e-6, what=f"{kind} {mode}",
                 scale=d["b"] if mode == "residual" else None)


@pytest.mark.parametrize("kind", ["const", "vary"])
def test_single_colour_pass_composes_the_sweep(pass_data, kind):
    """Two single-colour passes are one red/black sweep, and each leaves the
    other colour untouched."""
    d = pass_data
    O, b, x = d["offsets"], to_t(d["b"]), to_t(d["x"])
    if kind == "const":
        first, half, sweep = (to_t(d["values"]), tkernels.rbgs_half_sweep_const_3d,
                              tkernels.rbgs_const_3d)
    else:
        first, half, sweep = (to_t(d["coeffs"]), tkernels.rbgs_half_sweep_vary_3d,
                              tkernels.rbgs_vary_3d)
    red = half(first, O, b, x, 0)
    mask = tsmoothers.red_mask(KSHAPE)
    assert torch.equal(red[~mask], x[~mask]) and not torch.equal(red[mask], x[mask])
    both = half(first, O, b, red, 1)
    assert torch.equal(both, sweep(first, O, b, x, 1))


def test_2d_operand_is_lifted(pass_data):
    """A (ny, nx) operand runs as (1, ny, nx); against the reference's
    varying kernel on the same 2D operand (one traced call)."""
    shape = (8, 128)
    offsets, coeffs = tpoisson.diffusion_stencil(_medium(shape))
    coeffs = coeffs.astype(np.float32)
    b, x = rand(shape, 2), rand(shape, 3)
    ref = to_n(jkernels.rbgs_vary_3d(to_j(coeffs), offsets, to_j(b), to_j(x), 1))
    got = tkernels.rbgs_vary_3d(to_t(coeffs), offsets, to_t(b), to_t(x), 1)
    assert tuple(got.shape) == shape
    assert_close(got, ref, factor=2e-6, what="2D lift")
    vals = to_t(np.asarray([4.0, -1, -1, -1, -1]))
    r = tkernels.residual_const_3d(vals, offsets, to_t(b), to_t(x))
    op = tstencil.StencilOperator(None, offsets, vals, shape)
    assert_close(r, to_t(b) - tstencil.apply(op, to_t(x)), factor=2e-6,
                 scale=b, what="2D constant residual")


def test_cornered_pass_matches_the_smoothers():
    """K3's cornered form (one pass, tap rows from the region table) against
    the independent formulation of ``smoothers`` / ``stencil.residual``."""
    h = tmg.setup(
        (8, 12, 16),
        tmg.SolverConfig(transfer="linear", gridlevels=2, max_dense_coarse=512),
        device="cpu",
    ).hierarchy
    L = h.levels[1]
    assert isinstance(L.A, tstencil.CorneredOperator)
    b, x = to_t(rand(L.grid_shape, 4)), to_t(rand(L.grid_shape, 5))
    corner = tfused._corner_info(L.A)
    V, O = L.A.values, L.A.offsets
    assert_close(tkernels.residual_const_3d(V, O, b, x, corner=corner),
                 tstencil.residual(L.A, b, x), factor=2e-6, scale=b)
    assert_close(tkernels.jacobi_const_3d(V, O, b, x, 2, OMEGA, corner=corner),
                 tsmoothers.jacobi(L.A, L.inv_diag, b, x, 2, OMEGA), factor=4e-6)
    assert_close(tkernels.rbgs_const_3d(V, O, b, x, 2, corner=corner),
                 tsmoothers.rbgs(L.A, L.inv_diag, b, x, 2), factor=4e-6)


def test_cpu_passes_do_not_count_as_launches(pass_data):
    d = pass_data
    before = (tkernels.LAUNCHES_K3, tkernels.LAUNCHES_K4)
    tkernels.residual_const_3d(to_t(d["values"]), d["offsets"], to_t(d["b"]), to_t(d["x"]))
    tkernels.residual_vary_3d(to_t(d["coeffs"]), d["offsets"], to_t(d["b"]), to_t(d["x"]))
    assert (tkernels.LAUNCHES_K3, tkernels.LAUNCHES_K4) == before


def test_pass_wrappers_never_give_way_to_the_plain_version(monkeypatch, pass_data):
    """By the tensor's device alone: a tensor that is not on the CPU goes
    for the kernel (here: is refused) and never runs the plain version."""
    called = []
    monkeypatch.setattr(tkernels, "half_sweep_plain", lambda *a, **k: called.append(1))
    monkeypatch.setattr(tkernels, "half_sweep_vary_plain", lambda *a, **k: called.append(1))
    meta = torch.empty(KSHAPE, dtype=torch.float32, device="meta")
    vals = torch.empty((7,), dtype=torch.float32, device="meta")
    cfs = torch.empty((7,) + KSHAPE, dtype=torch.float32, device="meta")
    O = pass_data["offsets"]
    for call in (
        lambda: tkernels.residual_const_3d(vals, O, meta, meta),
        lambda: tkernels.jacobi_const_3d(vals, O, meta, meta, 1, OMEGA),
        lambda: tkernels.rbgs_const_3d(vals, O, meta, meta, 1),
        lambda: tkernels.rbgs_half_sweep_const_3d(vals, O, meta, meta, 0),
        lambda: tkernels.residual_vary_3d(cfs, O, meta, meta),
        lambda: tkernels.jacobi_vary_3d(cfs, O, meta, meta, 1, OMEGA),
        lambda: tkernels.rbgs_vary_3d(cfs, O, meta, meta, 1),
        lambda: tkernels.rbgs_half_sweep_vary_3d(cfs, O, meta, meta, 1),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert not called


# ---------------------------------------------------------------------------
# (a2) one leg of a varying-level visit in one call (sweeps_vary_3d)
# ---------------------------------------------------------------------------


def _coeffs27():
    """27 diagonally dominant coefficient grids at KSHAPE, in the order the
    port builds a Galerkin level's offsets."""
    offsets = ((0, 0, 0),) + tuple(
        o for o in itertools.product((-1, 0, 1), repeat=3) if any(o))
    rng = np.random.default_rng(27)
    coeffs = -(0.01 + 0.02 * rng.random((27,) + KSHAPE))
    coeffs[0] = 1.0 + 0.1 * rng.random(KSHAPE)
    return offsets, coeffs.astype(np.float32)


@pytest.fixture(scope="module")
def leg_reference(pass_data, pass_reference):
    """The reference's legs: a down-leg (two red/black sweeps from zero,
    then the residual) and an up-leg (two sweeps from x) at 7 taps (the
    up-leg is ``pass_reference``'s) and at 27 taps: five traced calls."""
    d = pass_data
    b, x, z = to_j(d["b"]), to_j(d["x"]), to_j(np.zeros(KSHAPE, np.float32))
    out = {}
    for taps, (O, c) in ((7, (d["offsets"], d["coeffs"])), (27, _coeffs27())):
        c = to_j(c)
        down = jkernels.rbgs_vary_3d(c, O, b, z, 2)
        out[(taps, "down")] = (to_n(down), to_n(jkernels.residual_vary_3d(c, O, b, down)))
        out[(taps, "up")] = (pass_reference[("vary", "rbgs")] if taps == 7
                             else to_n(jkernels.rbgs_vary_3d(c, O, b, x, 2)))
    return out


@pytest.mark.parametrize("mode", ["rbgs", "jacobi"])
@pytest.mark.parametrize("start", ["zero", "x"])
def test_leg_plain_is_the_loop_of_passes(pass_data, mode, start):
    """The leg's plain version, and its entry on CPU tensors, equal the loop
    of single passes bit for bit (colours 0, 1, 0, … from zero or x)."""
    d = pass_data
    O, c, b = d["offsets"], to_t(d["coeffs"]), to_t(d["b"])
    x0 = None if start == "zero" else to_t(d["x"])
    x = torch.zeros_like(b) if x0 is None else x0
    for j in range(3):
        x = tkernels.half_sweep_vary_plain(c, O, b, x, mode, OMEGA, j & 1)
    r = tkernels.half_sweep_vary_plain(c, O, b, x, "residual")
    before = tkernels.LAUNCHES_K4
    for fn in (tkernels.sweeps_vary_plain, tkernels.sweeps_vary_3d):
        got_x, got_r = fn(c, O, b, x0, 3, mode, OMEGA, emit_residual=True)
        assert torch.equal(got_x, x) and torch.equal(got_r, r)
        assert torch.equal(fn(c, O, b, x0, 3, mode, OMEGA), x)
    assert tkernels.LAUNCHES_K4 == before
    # no passes: the start itself, and its residual
    got_x, got_r = tkernels.sweeps_vary_3d(c, O, b, x0, 0, mode, emit_residual=True)
    want = torch.zeros_like(b) if x0 is None else x0
    assert torch.equal(got_x, want)
    assert torch.equal(got_r, tkernels.half_sweep_vary_plain(c, O, b, want, "residual"))


@pytest.mark.parametrize("leg", ["down", "up"])
@pytest.mark.parametrize("taps", [7, 27])
def test_leg_matches_reference_kernels(pass_data, leg_reference, taps, leg):
    """A down-leg (four passes from zero and the residual) and an up-leg
    (four passes from x) against the reference's ``rbgs_vary_3d`` and
    ``residual_vary_3d``: 2e-6·max|ref| for the iterate, 2e-6·max|b| for
    the residual, as for single passes."""
    d = pass_data
    O, c = (d["offsets"], d["coeffs"]) if taps == 7 else _coeffs27()
    c, b = to_t(c), to_t(d["b"])
    if leg == "down":
        got_x, got_r = tkernels.sweeps_vary_3d(c, O, b, None, 4, emit_residual=True)
        want_x, want_r = leg_reference[(taps, "down")]
        assert_close(got_r, want_r, factor=2e-6, scale=d["b"], what="residual")
    else:
        got_x = tkernels.sweeps_vary_3d(c, O, b, to_t(d["x"]), 4)
        want_x = leg_reference[(taps, "up")]
    assert_close(got_x, want_x, factor=2e-6, what=f"{taps}-tap {leg}-leg")


@pytest.mark.parametrize("passes,residual", [(4, True), (4, False), (0, True), (9, True)])
def test_leg_launches_cover_the_passes_in_order(passes, residual):
    """A leg's launches on the card: every pass once, in order, at most the
    operator's depth a launch, the residual in the last; a 27-point
    operator whose grids do not fit in L2 takes one pass a launch."""
    for taps, points in ((5, 256 ** 2), (7, 256 ** 3), (9, 4096 ** 2),
                         (27, 128 ** 3), (27, 64 ** 3)):
        cap = tkernels.leg_depth(taps, points)
        chunks = tkernels.leg_chunks(passes, residual, cap)
        starts = [start for start, _, _ in chunks]
        assert starts == sorted(starts) and chunks[0][0] == 0
        assert sum(n for _, n, _ in chunks) == passes
        assert all(n + r <= cap for _, n, r in chunks)
        assert [r for _, _, r in chunks] == [False] * (len(chunks) - 1) + [residual]
        assert len(chunks) == -(-(passes + residual) // cap)
    assert tkernels.leg_depth(27, 128 ** 3) == 1
    assert tkernels.leg_depth(27, 64 ** 3) == tkernels.leg_depth(7, 256 ** 3) > 1


def test_leg_ring_only_where_a_tile_fits():
    """The coefficient ring is asked for on Jacobi launches of depth 2 and
    up to 9 taps only: deeper, or at 27 taps, its shared memory leaves no
    useful tile, and red/black launches go without it."""
    assert tkernels.leg_ring(7, 2, "jacobi") and tkernels.leg_ring(9, 2, "jacobi")
    assert not any(tkernels.leg_ring(t, d, m) for t, d, m in (
        (7, 3, "jacobi"), (9, 3, "jacobi"), (27, 2, "jacobi"), (7, 2, "rbgs")))


def test_leg_wrapper_never_gives_way_to_the_plain_version(monkeypatch, pass_data):
    """By the tensor's device alone: ``sweeps_vary_3d`` on a tensor that is
    not on the CPU goes for the kernel (here: is refused) and never runs the
    plain version, in 3D and lifted from 2D."""
    called = []
    for name in ("half_sweep_vary_plain", "sweeps_vary_plain"):
        monkeypatch.setattr(tkernels, name, lambda *a, **k: called.append(1))
    O = pass_data["offsets"]
    meta = torch.empty(KSHAPE, dtype=torch.float32, device="meta")
    cfs = torch.empty((7,) + KSHAPE, dtype=torch.float32, device="meta")
    meta2 = torch.empty(KSHAPE[1:], dtype=torch.float32, device="meta")
    cfs2 = torch.empty((5,) + KSHAPE[1:], dtype=torch.float32, device="meta")
    O2 = tuple(off[1:] for off in O if off[0] == 0)
    for call in (
        lambda: tkernels.sweeps_vary_3d(cfs, O, meta, None, 4, emit_residual=True),
        lambda: tkernels.sweeps_vary_3d(cfs, O, meta, meta, 2, "jacobi"),
        lambda: tkernels.sweeps_vary_3d(cfs2, O2, meta2, None, 1),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert not called


def test_v_cycle_visits_varying_levels_by_legs(monkeypatch, pass_data):
    """``v_cycle`` runs a varying level's visit as two legs (the
    pre-smoothing with the residual, the post-smoothing), on the CPU too;
    the cycle equals one composed from the loop of single passes."""
    from openmg_tpu_torch.core import hierarchy as th
    from openmg_tpu_torch.ops.transfer import prolong, restrict

    shape = (8, 8, 16)
    offsets, coeffs = tpoisson.diffusion_stencil(_medium(shape))
    h = th.build_hierarchy(offsets, coeffs, gridlevels=2, max_dense_coarse=128,
                           residual_dtype="doublefloat",
                           transfer=TTRANSFERS["linear"], device="cpu")
    L = h.levels[0]
    assert not L.A.is_constant
    seen = []
    real = tkernels.sweeps_vary_3d

    def spy(*a, **k):
        seen.append((a[4], k.get("emit_residual", False)))
        return real(*a, **k)

    monkeypatch.setattr(tkernels, "sweeps_vary_3d", spy)
    r = to_t(rand(shape, 4))
    got = tcycle.run_cycle(h, r, "v", 2, 2, "rbgs", OMEGA)
    assert seen == [(4, True), (4, False)]
    c, O = L.A.coeffs, L.A.offsets
    x, res = tkernels.sweeps_vary_plain(c, O, r, None, 4, emit_residual=True)
    ec = tcycle.coarse_solve(h, restrict(res, h.transfer))
    x = x + prolong(ec, shape, h.transfer)
    assert torch.equal(got, tkernels.sweeps_vary_plain(c, O, r, x, 4))


# ---------------------------------------------------------------------------
# (b) host generators and the Dekker products, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 10), (4, 6, 8)])
@pytest.mark.parametrize("harmonic", [True, False])
def test_diffusion_stencil_bit_equal(shape, harmonic):
    kappa = _medium(shape)
    jo, jc = jpoisson.diffusion_stencil(kappa, harmonic)
    to, tc = tpoisson.diffusion_stencil(kappa, harmonic)
    assert to == jo
    np.testing.assert_array_equal(tc, jc)
    assert (tpoisson.diffusion(kappa, harmonic) != jpoisson.diffusion(kappa, harmonic)).nnz == 0
    with pytest.raises(ValueError):
        tpoisson.diffusion_stencil(np.zeros(shape))


@pytest.mark.parametrize("what", ["poisson", "diffusion"])
def test_stencil_from_csr_bit_equal(what):
    shape = (4, 6, 8)
    A = tpoisson.poisson(shape) if what == "poisson" else tpoisson.diffusion(_medium(shape))
    jo, jc = jpoisson.stencil_from_csr(A, shape)
    to, tc = tpoisson.stencil_from_csr(A, shape)
    assert to == jo and to[0] == (0, 0, 0)
    np.testing.assert_array_equal(tc, jc)
    assert (tpoisson.stencil_to_csr(to, tc) != A).nnz == 0
    with pytest.raises(ValueError):
        tpoisson.stencil_from_csr(A, (4, 6, 7))
    with pytest.raises(ValueError, match="distinct grid offsets"):
        tpoisson.stencil_from_csr(np.ones((192, 192)), shape)


def test_dekker_products_bit_equal():
    rng = np.random.default_rng(7)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    al = (a * np.float32(2.0 ** -25)).astype(np.float32)
    bl = (b * np.float32(2.0 ** -26)).astype(np.float32)
    for name, targs, jargs in (
        ("two_prod", (to_t(a), to_t(b)), (to_j(a), to_j(b))),
        ("df_mul", ((to_t(a), to_t(al)), (to_t(b), to_t(bl))),
         ((to_j(a), to_j(al)), (to_j(b), to_j(bl)))),
        ("df_mul_f32", ((to_t(a), to_t(al)), to_t(b)), ((to_j(a), to_j(al)), to_j(b))),
    ):
        got = getattr(tdf, name)(*targs)
        ref = getattr(jdf, name)(*jargs)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(to_n(g), to_n(r), err_msg=name)
    # the product is error-free: p + e == a·b exactly in float64
    p, e = tdf.two_prod(to_t(a), to_t(b))
    np.testing.assert_array_equal(
        to_n(p).astype(np.float64) + to_n(e).astype(np.float64),
        a.astype(np.float64) * b.astype(np.float64),
    )


# ---------------------------------------------------------------------------
# (c) build_hierarchy, bit for bit
# ---------------------------------------------------------------------------

HSHAPE = (16, 16, 16)


def _smooth_medium_problem():
    """The problem of ``tests/test_diffusion.py::test_smooth_medium_3d``."""
    zz, yy, _ = np.meshgrid(*[np.linspace(0, 1, s) for s in HSHAPE], indexing="ij")
    kappa = 1.0 + 0.5 * np.sin(2 * np.pi * zz) * np.cos(2 * np.pi * yy)
    offsets, coeffs = tpoisson.diffusion_stencil(kappa)
    return kappa, offsets, coeffs, tpoisson.rhs_random(HSHAPE, seed=2)


CFG_KW = dict(transfer="linear", cycles=100, gridlevels=3, max_dense_coarse=4096,
              residual_dtype="doublefloat")


@pytest.fixture(scope="module")
def reference():
    """The JAX package's setup and solve of the smooth-medium problem (its
    array path: no Pallas kernel takes nx = 16)."""
    _, offsets, coeffs, b = _smooth_medium_problem()
    solver = jmg.setup((offsets, coeffs), jmg.SolverConfig(**CFG_KW))
    x, info = solver.solve(b)
    return solver, np.asarray(x), info


@pytest.fixture(scope="module")
def port():
    _, offsets, coeffs, b = _smooth_medium_problem()
    solver = tmg.setup((offsets, coeffs), tmg.SolverConfig(**CFG_KW), device="cpu")
    x, info = solver.solve(b)
    return solver, x, info


def _assert_op_equal(t_op, j_op, what):
    assert tuple(t_op.offsets) == tuple(tuple(o) for o in j_op.offsets), what
    assert t_op.is_constant == j_op.is_constant, what
    if t_op.is_constant:
        np.testing.assert_array_equal(to_n(t_op.values), np.asarray(j_op.values), err_msg=what)
        assert tuple(t_op.grid_shape) == tuple(j_op.grid_shape)
    else:
        np.testing.assert_array_equal(to_n(t_op.coeffs), np.asarray(j_op.coeffs), err_msg=what)


def test_build_hierarchy_bit_equal(reference, port):
    hj, ht = reference[0].hierarchy, port[0].hierarchy
    assert ht.num_levels == hj.num_levels == 3
    assert ht.stats == tuple(hj.stats)
    for i, (Lt, Lj) in enumerate(zip(ht.levels, hj.levels)):
        assert not Lt.A.is_constant
        _assert_op_equal(Lt.A, Lj.A, f"level {i}")
        assert Lt.inv_diag.dtype == torch.float32
        np.testing.assert_array_equal(to_n(Lt.inv_diag), np.asarray(Lj.inv_diag))
    np.testing.assert_array_equal(to_n(ht.coarse_inv), np.asarray(hj.coarse_inv))
    _assert_op_equal(ht.fine_hi, hj.fine_hi, "fine_hi")
    _assert_op_equal(ht.fine_hi_lo, hj.fine_hi_lo, "fine_hi_lo")
    assert bool(ht.fine_hi_lo.coeffs.any())  # a true float64 operator: lo != 0


@pytest.mark.parametrize("rdtype", ["float32", "float64"])
def test_build_hierarchy_plain_residual_operator(rdtype):
    """The plain residual modes keep one fine operator of that type; a
    matrix's constant fine level is detected as constant."""
    shape = (8, 8, 8)
    offsets, coeffs = tpoisson.poisson_stencil(shape)
    kw = dict(gridlevels=2, max_dense_coarse=512)
    ht = thier.build_hierarchy(
        offsets, coeffs, dtype=torch.float32, residual_dtype=getattr(torch, rdtype),
        transfer=TTRANSFERS["linear"], device="cpu", **kw)
    hj = jhier.build_hierarchy(
        offsets, coeffs, residual_dtype=np.dtype(rdtype),
        transfer=JTRANSFERS["linear"], **kw)
    assert ht.fine_hi_lo is None and ht.fine_hi.dtype == getattr(torch, rdtype)
    np.testing.assert_array_equal(to_n(ht.fine_hi.coeffs), np.asarray(hj.fine_hi.coeffs))
    assert ht.levels[0].A.is_constant and hj.levels[0].A.is_constant
    assert not ht.levels[1].A.is_constant
    _assert_op_equal(ht.levels[1].A, hj.levels[1].A, "coarse level")


# ---------------------------------------------------------------------------
# (d) the V-cycle and the whole solve
# ---------------------------------------------------------------------------


def test_diffusion_solve_matches_reference(reference, port):
    _, xr, ri = reference
    _, xp, pi = port
    assert isinstance(xp, np.ndarray) and xp.dtype == np.float64 and xp.shape == HSHAPE
    assert pi["converged"] and ri["converged"]
    assert pi["cycles"] == ri["cycles"]
    for k, (a, b) in enumerate(zip(pi["residual_norms"], ri["residual_norms"])):
        assert b / 1.1 <= a <= b * 1.1, (k, a, b)
    assert pi["residual_mode"] == ri["residual_mode"] == "doublefloat"
    assert pi["level_stats"] == tuple(ri["level_stats"])
    kappa, _, _, b = _smooth_medium_problem()
    x_dir = spla.spsolve(tpoisson.diffusion(kappa).tocsc(), b.ravel())
    for x in (xp, xr):
        assert np.linalg.norm(x.ravel() - x_dir) / np.linalg.norm(x_dir) < 1e-8


def test_v_cycle_with_equal_setup_varying(reference):
    """The reference hierarchy carried across as numpy; one V(2,2) cycle of
    each side on the same right-hand side.  1e-5·max|ref|: three composed
    level visits whose smoothers divide by the diagonal here and multiply
    by its reciprocal there, and a dense coarse solve."""
    from openmg_tpu.core.cycle import run_cycle as j_run_cycle

    hj = reference[0].hierarchy
    ht = hierarchy_from_numpy(spec_from_jax_hierarchy(hj), "cpu")
    for Lt, Lj in zip(ht.levels, hj.levels):
        np.testing.assert_array_equal(to_n(Lt.inv_diag), np.asarray(Lj.inv_diag))
    r = rand(HSHAPE, 3)
    want = j_run_cycle(hj, to_j(r), "v", 2, 2, "rbgs", OMEGA)
    got = tcycle.run_cycle(ht, to_t(r), "v", 2, 2, "rbgs", OMEGA)
    assert_close(got, np.asarray(want), factor=1e-5, what="v_cycle")
    # and the solve on the carried hierarchy converges like the port's own
    _, _, _, b = _smooth_medium_problem()
    x, info = tmg.Solver(ht, tmg.SolverConfig(**CFG_KW)).solve(b)
    assert info["converged"] and info["cycles"] == reference[2]["cycles"]


def test_general_residual_matches_float64(port):
    """The Dekker-product residual of the (hi, lo) operator is the float64
    residual to double-float accuracy."""
    from openmg_tpu_torch.core.solver import _residual_norm_df

    solver, x, _ = port
    h = solver.hierarchy
    kappa, _, _, b = _smooth_medium_problem()
    x_df = tdf.df_split(x * (1 + 1e-9))
    (r_hi, r_lo), rn = _residual_norm_df(h.fine_hi, h.fine_hi_lo, tdf.df_split(b), x_df)
    want = b.ravel() - tpoisson.diffusion(kappa) @ tdf.df_merge(x_df).ravel()
    got = tdf.df_merge((r_hi, r_lo)).ravel()
    assert np.max(np.abs(got - want)) < 1e-12 * np.max(np.abs(b))
    assert float(rn) == pytest.approx(np.linalg.norm(want), rel=1e-4)


# ---------------------------------------------------------------------------
# (e) mg_solve with a matrix
# ---------------------------------------------------------------------------

MSHAPE = (8, 8, 16)
MPARAMS = {"problemshape": MSHAPE, "gridlevels": 2, "max_dense_coarse": 128,
           "transfer": "linear", "residual_dtype": "doublefloat"}


@pytest.mark.parametrize("what", ["poisson", "diffusion"])
def test_mg_solve_with_a_matrix(what):
    A = tpoisson.poisson(MSHAPE) if what == "poisson" else tpoisson.diffusion(_medium(MSHAPE))
    b = tpoisson.rhs_random(MSHAPE, seed=4)
    b /= np.linalg.norm(b)
    xr, ri = jmg.mg_solve(A, b.ravel(), MPARAMS)
    xp, pi = tmg.mg_solve(A, b.ravel(), MPARAMS, device="cpu")
    assert xp.shape == (b.size,) and xp.dtype == np.float64
    assert pi["converged"] and pi["cycles"] == ri["cycles"]
    for a, r in zip(pi["residual_norms"], ri["residual_norms"]):
        assert r / 1.1 <= a <= r * 1.1
    assert np.linalg.norm(b.ravel() - A @ xp) < 1e-10 * 1.05
    lam_min = spla.eigsh(A.tocsc(), k=1, sigma=0, return_eigenvectors=False)[0]
    assert np.linalg.norm(xp - np.asarray(xr)) <= 2e-10 / lam_min
    # a dense array is a matrix too
    if what == "poisson":
        small = (4, 4, 4)
        xd, di = tmg.mg_solve(
            tpoisson.poisson(small).toarray(), np.ones(64),
            {"problemshape": small, "gridlevels": 2, "max_dense_coarse": 8},
            device="cpu")
        assert di["converged"]
        np.testing.assert_allclose(tpoisson.poisson(small) @ xd, np.ones(64), atol=1e-9)


def test_mg_solve_refuses_what_waits_for_the_sparse_engine():
    """A matrix with no stencil form and the sparse formats go through the
    sparse engine now, with PCG, FMG and ``solve_many``, which were refused
    before they were ported."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 64))
    dense = g @ g.T + 64.0 * np.eye(64)  # SPD, every entry nonzero
    p = {"problemshape": (4, 4, 4)}
    x, info = tmg.mg_solve(dense, np.ones(64), p, device="cpu")
    assert info["format"] == "ell" and info["converged"]
    np.testing.assert_allclose(dense @ x, np.ones(64), atol=1e-9)
    with pytest.raises(ValueError, match="distinct grid offsets"):
        tmg.mg_solve(dense, np.ones(64), {**p, "format": "stencil"}, device="cpu")
    for fmt in ("csr", "ell", "bsr", "dense"):
        x, info = tmg.mg_solve(sp.identity(64, format="csr"), np.ones(64),
                               {**p, "format": fmt}, device="cpu")
        assert info["format"] == fmt
        np.testing.assert_allclose(x, np.ones(64), atol=1e-12)
    for kw in ({"krylov": "pcg"}, {"cycle_type": "f"}):
        x, info = tmg.mg_solve(dense, np.ones(64), {**p, **kw}, device="cpu")
        assert info["format"] == "ell" and info["converged"]
        np.testing.assert_allclose(dense @ x, np.ones(64), atol=1e-9)
    solver = tmg.setup_sparse(dense, (4, 4, 4), device="cpu")
    xs, info = solver.solve_many([np.ones(64), 2 * np.ones(64)])
    assert all(info["converged"]) and xs.shape == (2, 64)
    np.testing.assert_allclose(dense @ xs[1], 2 * np.ones(64), atol=1e-9)


# ---------------------------------------------------------------------------
# (f) the plain residual modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rdtype,threshold", [("float32", 2e-4), ("float64", 1e-10),
                                              (None, 2e-4)])
def test_plain_residual_modes(port, rdtype, threshold):
    """float32 (also what None resolves to) stalls at its rounding floor, so
    its threshold is scaled to ‖b‖ ≈ 64; float64 reaches 1e-10."""
    _, offsets, coeffs, b = _smooth_medium_problem()
    kappa = _smooth_medium_problem()[0]
    cfg = tmg.SolverConfig(**{**CFG_KW, "residual_dtype": rdtype, "threshold": threshold})
    solver = tmg.setup((offsets, coeffs), cfg, device="cpu")
    want_dtype = torch.float64 if rdtype == "float64" else torch.float32
    assert solver.hierarchy.fine_hi.dtype == want_dtype
    assert solver.hierarchy.fine_hi_lo is None
    x, info = solver.solve(b)
    assert info["converged"] and info["residual_mode"] == (rdtype or "float32")
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    r = b.ravel() - tpoisson.diffusion(kappa) @ x.ravel()
    assert np.linalg.norm(r) < threshold * (1.05 if rdtype == "float64" else 1.5)
    # the first cycles do not depend on the residual's precision
    ref = port[2]["residual_norms"]
    for a, d in list(zip(info["residual_norms"], ref))[:3]:
        assert d / 1.01 <= a <= d * 1.01
    # a float32 tensor comes back as a tensor of the residual's type
    xt, _ = solver.solve(torch.from_numpy(b.astype(np.float32)))
    assert isinstance(xt, torch.Tensor) and xt.dtype == want_dtype


def test_float64_residual_never_reaches_a_float32_kernel(monkeypatch):
    """The float64 outer residual is ``b − apply(A, x)``, on any device."""
    from openmg_tpu_torch.core import solver as tsolver

    monkeypatch.setattr(tsolver, "stencil_residual",
                        lambda *a, **k: pytest.fail("routed through residual()"))
    shape = (8, 8, 8)
    cfg = tmg.SolverConfig(gridlevels=2, max_dense_coarse=512, residual_dtype="float64")
    b = tpoisson.rhs_random(shape, seed=1)
    x, info = tmg.solve(shape, b / np.linalg.norm(b), cfg, device="cpu")
    assert info["converged"] and info["residual_mode"] == "float64"


# ---------------------------------------------------------------------------
# (h) on the card the public functions reach the kernels
# ---------------------------------------------------------------------------


def test_residual_and_smooth_reach_the_kernel_wrappers(monkeypatch, port):
    """With the device check answering "not the CPU", ``stencil.residual``
    and ``smoothers.smooth`` go to the kernel entry points (K1 first on a
    constant operator, K3 where it declines, K4 on a varying one) and never
    to the plain tensor code."""
    seen = []

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            seen.append(name)
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for name in ("residual_const_3d", "residual_vary_3d", "jacobi_const_3d",
                 "rbgs_const_3d", "jacobi_vary_3d", "rbgs_vary_3d"):
        spy(tkernels, name)
    spy(tfused, "smooth_fused")
    monkeypatch.setattr(tstencil, "_on_cpu", lambda t: False)
    for name in ("jacobi", "rbgs"):
        monkeypatch.setattr(tsmoothers, name,
                            lambda *a, **k: pytest.fail("plain smoother on the card"))
    monkeypatch.setattr(tstencil, "apply",
                        lambda *a, **k: pytest.fail("plain apply in residual()"))

    vary = port[0].hierarchy.levels[0]
    const = tmg.setup((8, 8, 8), tmg.SolverConfig(gridlevels=2, max_dense_coarse=512),
                      device="cpu").hierarchy.levels[0]
    b, x = to_t(rand(HSHAPE, 8)), to_t(rand(HSHAPE, 9))
    bc, xc = to_t(rand((8, 8, 8), 8)), to_t(rand((8, 8, 8), 9))

    tstencil.residual(vary.A, b, x)
    tsmoothers.smooth("rbgs", vary.A, vary.inv_diag, b, x, 1, OMEGA)
    tsmoothers.smooth("jacobi", vary.A, vary.inv_diag, b, x, 1, OMEGA)
    assert seen == ["residual_vary_3d", "rbgs_vary_3d", "jacobi_vary_3d"]
    del seen[:]
    tstencil.residual(const.A, bc, xc)
    tsmoothers.smooth("rbgs", const.A, const.inv_diag, bc, xc, 1, OMEGA)
    assert seen == ["residual_const_3d", "smooth_fused"]
    del seen[:]
    with monkeypatch.context() as m:
        m.setattr(tfused, "smooth_fused", lambda *a, **k: None)  # K1 declines
        tsmoothers.smooth("rbgs", const.A, const.inv_diag, bc, xc, 1, OMEGA)
        tsmoothers.smooth("jacobi", const.A, const.inv_diag, bc, xc, 1, OMEGA)
    assert seen == ["rbgs_const_3d", "jacobi_const_3d"]
    # what no kernel takes raises instead of running tensor code
    with pytest.raises(NotImplementedError, match="float32"):
        tstencil.residual(vary.A, b.double(), x.double())
    with pytest.raises(NotImplementedError, match="float32"):
        tsmoothers.smooth("rbgs", vary.A, vary.inv_diag, b.double(), x.double(), 1, OMEGA)
    # Chebyshev: one per-pass residual launch an iteration, never apply()
    del seen[:]
    y = tsmoothers.smooth("chebyshev", vary.A, vary.inv_diag, b, x, 2, OMEGA)
    assert seen == ["residual_vary_3d"] * 2 and bool(torch.isfinite(y).all())
    with pytest.raises(NotImplementedError, match="float32"):
        tsmoothers.smooth("chebyshev", vary.A, vary.inv_diag, b.double(),
                          x.double(), 1, OMEGA)
