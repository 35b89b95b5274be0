"""The halo forms on a batch, K1hb–K4hb and K6hb: K members of a rank's
slab (or row block) in one launch, each member with its own received planes
(the JAX package's halo kernels under ``jax.vmap``), on the CPU.

* Each batched plain form against the scalar plain halo form member by
  member, bit for bit: K1hb's down-leg, up-leg with ``ec`` and residual with
  restriction on the constant and the cornered level (slabs of the first,
  an inner and the last rank), K2hb, K3hb in every mode, K4hb, on the slabs
  of a (16, 8, 128) grid and of a 2D grid cut along y; K6hb at H = 1 and
  H > 1.  The members' planes differ (a member offset that read another
  member's planes would show).
* One case a form against the JAX package's halo function under
  ``jax.vmap`` in interpret mode (one trace each: a trace costs seconds),
  with ``tests/test_torch_halo.py``'s tolerance, 2e-6·max|ref| (K2 bit for
  bit); K6hb against the arithmetic of the reference's
  ``_spmv_banded_local`` (its halo-extended slices), vmapped.
* On CPU tensors the wrappers run their plain versions and count no
  launch; they refuse operands they do not take (shapes, member counts,
  halo depth) before anything is launched.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from openmg_tpu.ops import fused as jfused
from openmg_tpu.ops import kernels as jk
from openmg_tpu_torch.ops import ell
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import kernels as tk
from openmg_tpu_torch.ops import transfer as ttr

from _torch_parity import assert_close, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

K = 3
OMEGA = 2.0 / 3.0
GLOBAL = (16, 8, 128)
P = 2
MODES = [("jacobi", 0), ("rbgs", 0), ("rbgs", 1), ("residual", 0)]
LIN_KW = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat")


def stack(shape, seed, scale=1.0):
    """K members of ``shape``, each its own draw (numpy float32)."""
    return np.stack([rand(shape, seed + 7 * m) * scale for m in range(K)]).astype(np.float32)


def cut(a, i, parts, lo, hi):
    """Slab ``i`` of ``parts`` along axis 1 of a stack ``a`` and every
    member's received slabs: the ``lo`` last planes of slab i − 1 and the
    ``hi`` first of slab i + 1 (zeros at the domain edges)."""
    n = a.shape[1] // parts
    z = lambda k: np.zeros((a.shape[0], k) + a.shape[2:], a.dtype)  # noqa: E731
    lower = a[:, i * n - lo:i * n] if i > 0 else z(lo)
    upper = a[:, (i + 1) * n:(i + 1) * n + hi] if i < parts - 1 else z(hi)
    return tuple(map(np.ascontiguousarray, (a[:, i * n:(i + 1) * n], lower, upper)))


def members_equal(got, one, what):
    """``got`` (a tensor or tuple of stacks) equals ``one(m)`` for every
    member m, bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    for m in range(K):
        want = one(m)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g[m], w), f"{what}: member {m} output {j}"


@pytest.fixture(scope="module")
def port_ops():
    """The port's constant 7-point operator of ``GLOBAL`` and a cornered
    27-point level of that shape (the Galerkin level of twice the grid), a
    2D cornered level of (24, 20) and the 7-point offsets and values the
    reference cases take."""
    import openmg_tpu_torch as tmg
    from openmg_tpu_torch.models.poisson import poisson_offsets

    cfg = tmg.SolverConfig(gridlevels=2, max_dense_coarse=1 << 16, **LIN_KW)
    # three levels: the coarsest (8, 4, 64) keeps the dense inverse small
    c3 = tmg.setup(tuple(2 * v for v in GLOBAL), dataclasses.replace(cfg, gridlevels=3),
                   device="cpu").hierarchy.levels[1].A
    a0 = tmg.setup(GLOBAL, cfg, device="cpu").hierarchy.levels[0].A
    c2 = tmg.setup((48, 40), cfg, device="cpu").hierarchy.levels[1].A
    offs = poisson_offsets(3)
    vals = np.asarray([6.0] + [-1.0] * 6, np.float32)
    return {"const": a0, "cornered": c3, "2d": c2, "poisson": (offs, vals)}


# ---------------------------------------------------------------------------
# the batched plain forms, member by member against the scalar ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["const", "cornered", "2d"])
@pytest.mark.parametrize("mode,color", MODES)
def test_k3hb_is_the_scalar_halo_pass_member_by_member(port_ops, kind, mode, color):
    A = port_ops[kind]
    corner = tfused._corner_info(A)
    shape = A.grid_shape
    b, x = stack(shape, 1), stack(shape, 2)
    for i in range(4):
        bs = to_t(cut(b, i, 4, 0, 0)[0])
        xs, lo, hi = map(to_t, cut(x, i, 4, 1, 1))
        got = tk.halo_half_sweep_batch(A.values, A.offsets, bs, xs, mode, OMEGA, color,
                                       lo, hi, corner=corner, open_lo=int(i > 0))
        assert got.shape == xs.shape
        members_equal(got, lambda m: tk.halo_half_sweep_const_3d(
            A.values, A.offsets, bs[m], xs[m], mode, OMEGA, color, lo[m], hi[m],
            corner=corner, open_lo=int(i > 0)), f"K3hb {kind} {mode} slab {i}")


@pytest.mark.parametrize("kind", ["3d", "2d"])
def test_k4hb_is_the_scalar_halo_pass_member_by_member(port_ops, kind):
    A = port_ops["cornered" if kind == "3d" else "2d"].to_varying()
    shape = A.grid_shape
    n = shape[0] // 4
    b, x = stack(shape, 3), stack(shape, 4)
    for mode, color in MODES:
        for i in range(4):
            c = A.coeffs[:, i * n:(i + 1) * n].contiguous()
            bs = to_t(cut(b, i, 4, 0, 0)[0])
            xs, lo, hi = map(to_t, cut(x, i, 4, 1, 1))
            got = tk.halo_half_sweep_vary_batch(c, A.offsets, bs, xs, mode, OMEGA, color,
                                                lo, hi)
            members_equal(got, lambda m: tk.halo_half_sweep_vary_3d(
                c, A.offsets, bs[m], xs[m], mode, OMEGA, color, lo[m], hi[m]),
                f"K4hb {kind} {mode} slab {i}")


def _k2_operands(shape, seed):
    return [stack(shape, seed + j, s) for j, s in enumerate((1, 1e-8, 1e-3, 1, 1e-8))]


TERMS = ((4.0, 2.0),) + ((-1.0,),) * 6


def test_k2hb_is_the_scalar_halo_step_member_by_member(port_ops):
    A = port_ops["const"]
    arrs = _k2_operands(A.grid_shape, 60)
    for i in range(4):
        sl = [tuple(map(to_t, cut(a, i, 4, 1, 1))) for a in arrs]
        halos = tuple((s[1], s[2]) for s in sl[:3])
        got = tk.df_update_residual_batch(A.offsets, TERMS, *[s[0] for s in sl],
                                          emit_norm=True, halos=halos)
        members_equal(got, lambda m: tk.df_update_residual_const_3d(
            A.offsets, TERMS, *[s[0][m] for s in sl], emit_norm=True,
            halos=tuple((lo[m], hi[m]) for lo, hi in halos)), f"K2hb slab {i}")


K1_VISITS = {
    "down: zero start, 2 rb, restrict": (
        dict(stages=tfused.stages_for("rbgs", 1, OMEGA), emit_residual=True), False, False),
    "up: x + P ec, 2 rb": (dict(stages=tfused.stages_for("rbgs", 1, OMEGA)), True, True),
    "residual + restrict": (dict(stages=(), emit_residual=True, emit_x=False), True, False),
}


@pytest.mark.parametrize("kind", ["const", "cornered"])
@pytest.mark.parametrize("visit", list(K1_VISITS))
def test_k1hb_is_the_scalar_halo_visit_member_by_member(port_ops, kind, visit):
    A = port_ops[kind]
    tr = ttr.TRANSFERS["linear"]
    kw, has_x, use_ec = K1_VISITS[visit]
    kw = dict(kw, **({"ec": None, "prolong_transfer": tr} if use_ec else
                     {"restrict_transfer": tr}))
    depth = tfused.halo_depth(len(kw["stages"]), kw.get("emit_residual", False),
                              "restrict_transfer" in kw, use_ec)
    shape = A.grid_shape
    b, x = stack(shape, 71), stack(shape, 72)
    ec = stack(tuple(s // 2 for s in shape), 73)
    corner = tfused._corner_info(A)
    for i in range(P):
        bs, blo, bhi = map(to_t, cut(b, i, P, depth, depth))
        xs, xlo, xhi = map(to_t, cut(x, i, P, depth, depth))
        es, elo, ehi = map(to_t, cut(ec, i, P, depth // 2, depth // 2 + 1))
        flags = (int(i > 0), int(i < P - 1))
        halos = (flags, (blo, bhi), (xlo, xhi) if has_x else None,
                 (elo, ehi) if use_ec else None)
        bkw = dict(kw, ec=es) if use_ec else kw
        got = tfused.fused_stages_const_3d_batch(
            A.values, A.offsets, bs, xs if has_x else None, corner=corner,
            halos=halos, **bkw)

        def one(m):
            mh = (flags,) + tuple(None if p is None else (p[0][m], p[1][m])
                                  for p in halos[1:])
            mkw = dict(kw, ec=es[m]) if use_ec else kw
            return tfused.fused_stages_const_3d(
                A.values, A.offsets, bs[m], xs[m] if has_x else None, corner=corner,
                halos=mh, **mkw)

        members_equal(got, one, f"K1hb {kind} {visit} slab {i}")


@pytest.mark.parametrize("H", [1, 5])
def test_k6hb_is_k6h_member_by_member(H):
    """Offsets 0, ±1, ±H; each member's received rows its own."""
    m = 24
    offs = tuple(sorted({0, -1, 1, -H, H}))
    rng = np.random.default_rng(H)
    data = torch.from_numpy(rng.standard_normal((len(offs), m)).astype(np.float32))
    x, lo, hi = (torch.from_numpy(stack(s, 80 + j)) for j, s in enumerate(((m,), (H,), (H,))))
    got = ell.spmv_banded_halo_batch(data, offs, x, lo, hi)
    members_equal(got, lambda k: ell.spmv_banded_halo(data, offs, x[k], lo[k], hi[k]),
                  f"K6hb H {H}")


# ---------------------------------------------------------------------------
# one case a form against the JAX package's halo functions under jax.vmap
# ---------------------------------------------------------------------------


def test_k3hb_matches_vmapped_reference(port_ops):
    offs, vals = port_ops["poisson"]
    b, x = stack(GLOBAL, 11), stack(GLOBAL, 12)
    bs = cut(b, 1, P, 0, 0)[0]
    xs, lo, hi = cut(x, 1, P, 1, 1)
    ref = jax.vmap(lambda bb, xx, l, h: jk.halo_half_sweep_const_3d(
        to_j(vals), offs, bb, xx, "rbgs", OMEGA, 1, l, h))(*map(to_j, (bs, xs, lo, hi)))
    got = tk.halo_half_sweep_batch(to_t(vals), offs, to_t(bs), to_t(xs), "rbgs", OMEGA, 1,
                                   to_t(lo), to_t(hi), open_lo=1)
    assert_close(got, to_n(ref), what="K3hb rbgs")


def test_k4hb_matches_vmapped_reference(port_ops):
    offs, _ = port_ops["poisson"]
    c = 0.5 + np.random.default_rng(13).random((7,) + GLOBAL).astype(np.float32)
    c[0] += 6.0
    b, x = stack(GLOBAL, 14), stack(GLOBAL, 15)
    cs = np.ascontiguousarray(c[:, :GLOBAL[0] // P])
    bs = cut(b, 0, P, 0, 0)[0]
    xs, lo, hi = cut(x, 0, P, 1, 1)
    ref = jax.vmap(lambda bb, xx, l, h: jk.halo_half_sweep_vary_3d(
        to_j(cs), offs, bb, xx, "jacobi", OMEGA, 0, l, h))(*map(to_j, (bs, xs, lo, hi)))
    got = tk.halo_half_sweep_vary_batch(to_t(cs), offs, to_t(bs), to_t(xs), "jacobi",
                                        OMEGA, 0, to_t(lo), to_t(hi))
    assert_close(got, to_n(ref), what="K4hb jacobi")


def test_k2hb_bit_equal_to_vmapped_reference(port_ops):
    offs, _ = port_ops["poisson"]
    arrs = _k2_operands(GLOBAL, 20)
    sl = [cut(a, 1, P, 1, 1) for a in arrs]
    ref = jax.vmap(lambda xh, xl, e, bh, bl, h1, h2, l1, l2, e1, e2:
                   jk.df_update_residual_const_3d(
                       offs, TERMS, xh, xl, e, bh, bl,
                       halos=((h1, h2), (l1, l2), (e1, e2)), emit_norm=True))(
        *[to_j(s[0]) for s in sl], *[to_j(t) for s in sl[:3] for t in s[1:]])
    got = tk.df_update_residual_batch(
        offs, TERMS, *[to_t(s[0]) for s in sl], emit_norm=True,
        halos=tuple((to_t(s[1]), to_t(s[2])) for s in sl[:3]))
    for j, name in enumerate(("x_hi", "x_lo", "r_hi")):
        np.testing.assert_array_equal(to_n(got[j]), np.asarray(ref[j]), err_msg=name)
    for m in range(K):
        np.testing.assert_allclose(float(got[3][m].double().sum()),
                                   float(np.asarray(ref[3][m])[:, 0, 0].sum()), rtol=1e-6)


def test_k1hb_matches_vmapped_reference(port_ops):
    """The up-leg: ``x + P ec`` and two red/black stages, with slabs of
    ``b``, ``x`` and the coarse ``ec`` from both neighbours."""
    from openmg_tpu.ops.transfer import TRANSFERS as JT

    offs, vals = port_ops["poisson"]
    stages = tfused.stages_for("rbgs", 1, OMEGA)
    depth = tfused.halo_depth(len(stages), False, False, True)
    b, x = stack(GLOBAL, 21), stack(GLOBAL, 22)
    ec = stack(tuple(s // 2 for s in GLOBAL), 23)
    sb, sx = cut(b, 1, P, depth, depth), cut(x, 1, P, depth, depth)
    se = cut(ec, 1, P, depth // 2, depth // 2 + 1)
    flags = (1, 0)
    jflags = to_j(np.asarray([flags], np.float32))

    def ref_one(bb, xx, ee, b1, b2, x1, x2, e1, e2):
        return jfused.fused_stages_const_3d(
            to_j(vals), offs, bb, xx, stages, ec=ee, prolong_transfer=JT["linear"],
            halos=(jflags, (b1, b2), (x1, x2), (e1, e2)))

    ref = jax.vmap(ref_one)(to_j(sb[0]), to_j(sx[0]), to_j(se[0]),
                            *[to_j(t) for s in (sb, sx, se) for t in s[1:]])
    got = tfused.fused_stages_const_3d_batch(
        to_t(vals), offs, to_t(sb[0]), to_t(sx[0]), stages, ec=to_t(se[0]),
        prolong_transfer=ttr.TRANSFERS["linear"],
        halos=(flags, (to_t(sb[1]), to_t(sb[2])), (to_t(sx[1]), to_t(sx[2])),
               (to_t(se[1]), to_t(se[2]))))
    assert_close(got, to_n(ref), what="K1hb up-leg")


def test_k6hb_matches_vmapped_reference_arithmetic(monkeypatch):
    """The reference's ``_spmv_banded_local`` (its halo-extended slices)
    with the received rows given, under ``jax.vmap``."""
    import jax.numpy as jnp

    from openmg_tpu.parallel import sparse_dist as jsd

    m, H = 32, 4
    offs = (-H, -1, 0, 1, H)
    data = np.random.default_rng(5).standard_normal((len(offs), m)).astype(np.float32)
    x, lo, hi = stack((m,), 90), stack((H,), 91), stack((H,), 92)
    held = {}
    monkeypatch.setattr(jsd, "_extend", lambda v, h, axis, n: jnp.concatenate(
        [held["lo"], v, held["hi"]]))

    def one(xx, ll, hh):
        held.update(lo=ll, hi=hh)
        return jsd._spmv_banded_local(to_j(data), offs, H, xx, "x", P)

    ref = jax.vmap(one)(to_j(x), to_j(lo), to_j(hi))
    got = ell.spmv_banded_halo_batch(to_t(data), offs, to_t(x), to_t(lo), to_t(hi))
    assert_close(got, to_n(ref), what="K6hb")


# ---------------------------------------------------------------------------
# counts and refusals
# ---------------------------------------------------------------------------

COUNTERS = [(tfused, "LAUNCHES_HALO_BATCH"), (tk, "LAUNCHES_K2_HALO_BATCH"),
            (tk, "LAUNCHES_K3_HALO_BATCH"), (tk, "LAUNCHES_K4_HALO_BATCH"),
            (ell, "LAUNCHES_K6H_BATCH")]


def test_cpu_wrappers_count_no_launch(port_ops):
    A = port_ops["const"]
    slab = (4,) + tuple(A.grid_shape[1:])
    b, x = to_t(stack(slab, 1)), to_t(stack(slab, 2))
    lo = hi = to_t(stack((1,) + slab[1:], 3))
    before = [getattr(mod, name) for mod, name in COUNTERS]
    tk.halo_half_sweep_batch(A.values, A.offsets, b, x, "residual", 0.0, 0, lo, hi)
    coeffs = port_ops["cornered"].to_varying().coeffs[:, :4].contiguous()
    tk.halo_half_sweep_vary_batch(coeffs, A.offsets, b, x, "residual", 0.0, 0, lo, hi)
    tk.df_update_residual_batch(A.offsets, TERMS, b, x, x, b, b, emit_norm=True,
                                halos=((lo, hi),) * 3)
    tfused.fused_stages_const_3d_batch(A.values, A.offsets, b, x, (), emit_residual=True,
                                       halos=((1, 1), (lo, hi), (lo, hi), None))
    ell.spmv_banded_halo_batch(torch.ones(3, 8), (-1, 0, 1), to_t(stack((8,), 4)),
                               to_t(stack((1,), 5)), to_t(stack((1,), 6)))
    assert [getattr(mod, name) for mod, name in COUNTERS] == before


def _never_launch(*_):
    raise AssertionError("a kernel was launched")


def test_refusals_before_any_launch(port_ops, monkeypatch):
    """Bad operands raise ValueError, on the CPU path and on the card's
    (the CUDA wrappers called on CPU tensors with the launchers patched to
    fail: every refusal comes first)."""
    monkeypatch.setattr(tfused, "_kernel", _never_launch)
    monkeypatch.setattr(tk, "_kernel", _never_launch)
    monkeypatch.setattr(tk, "_sweep_kernel", _never_launch)
    monkeypatch.setattr(ell, "_kernel_halo", _never_launch)
    A = port_ops["const"]
    plane = tuple(A.grid_shape[1:])
    slab = (4,) + plane
    b, x = to_t(stack(slab, 1)), to_t(stack(slab, 2))
    one = to_t(stack((1,) + plane, 3))
    two = to_t(stack((2,) + plane, 4))
    short = one[:2]  # two members' planes for three
    V, O = A.values, A.offsets
    coeffs = port_ops["cornered"].to_varying().coeffs[:, :4].contiguous()
    with pytest.raises(ValueError, match="lower planes"):
        tk.halo_half_sweep_batch(V, O, b, x, "residual", 0.0, 0, short, one)
    with pytest.raises(ValueError, match="upper planes"):
        tk.halo_half_sweep_vary_batch(coeffs, O, b, x, "residual", 0.0, 0, one, two)
    with pytest.raises(ValueError, match="K2hb"):
        tk.df_update_residual_batch(O, TERMS, b, x, x, b, b, halos=((one, short),) * 3)
    with pytest.raises(ValueError, match="2D or 1D"):
        tk.df_update_residual_batch(((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)),
                                    ((4.0,),) + ((-1.0,),) * 4, *[b[:, 0]] * 5,
                                    halos=((one[:, :, 0], one[:, :, 0]),) * 3)
    with pytest.raises(ValueError, match="K1hb"):
        tfused.fused_stages_const_3d_batch(V, O, b, x, (), emit_residual=True,
                                           halos=((1, 1), (two, two), (short, short), None))
    with pytest.raises(ValueError, match="one launch"):
        tfused.fused_stages_const_3d_batch(V, O, b, x, tfused.stages_for("rbgs", 4, OMEGA),
                                           halos=((1, 1), (two, two), (two, two), None))
    with pytest.raises(ValueError, match="a member"):
        ell.spmv_banded_halo_batch(torch.ones(3, 8), (-1, 0, 1), to_t(stack((8,), 4)),
                                   to_t(stack((1,), 5))[:2], to_t(stack((1,), 6))[:2])
    with pytest.raises(ValueError, match="reach"):
        ell.spmv_banded_halo_batch(torch.ones(3, 8), (-2, 0, 2), to_t(stack((8,), 4)),
                                   to_t(stack((1,), 5)), to_t(stack((1,), 6)))
    # the card's wrappers on CPU tensors: each refuses before its launch
    with pytest.raises(ValueError, match="halo"):
        tk._half_sweep_cuda(V, O, b, x, "residual", 0.0, 0, False, None,
                            halos=(two, two), batch=True)
    with pytest.raises(ValueError, match="halo"):
        tk._df_update_residual_cuda(O, TERMS, b, x, x, b, b, True,
                                    halos=((two, two),) * 3, batch=True)
    with pytest.raises(ValueError, match="halo slabs"):
        # a residual with its restriction needs slabs two planes deep
        tfused._fused_stages_cuda(V, O, b, x, (), True, None, ttr.TRANSFERS["linear"],
                                  None, None, False,
                                  halos=((1, 1), (one, one), (one, one), None), batch=True)
    with pytest.raises(ValueError, match="halo"):
        tfused._fused_stages_cuda(V, O, b, x, (), True, None, None, None, None, True,
                                  halos=((1, 1), (two[:, 0], two[:, 0]), (two, two), None),
                                  batch=True)
