"""The halo forms of K1–K4: a rank's z-slab with the planes (or D-deep
slabs) received from the ranks below and above.

* The port's plain halo forms (``openmg_tpu_torch.ops.kernels`` /
  ``.fused`` with ``halos=``, on CPU tensors) against the JAX package's
  halo kernels in interpret mode, on the two slabs of a (16, 8, 128) grid
  (nx = 128, so the JAX package takes its Pallas path), each with the
  neighbour's planes cut from the whole grid and zeros at the domain edge.
  Tolerance 2e-6·max|ref| absolute (float32 sums in another order, fused
  multiply-adds on one side), K2 bit for bit.
* K3's halo form on the cornered level against the JAX package's partitioned
  cornered pass (its halo kernel and region fix-up under ``shard_map`` on two
  of the virtual CPU devices), same tolerance.
* Each plain form over P slabs against the plain whole-grid version row for
  row (no reference trace: cheap), on the constant 7-point and the cornered
  27-point operators, a varying operator, and a 2D slab partitioned along y.

Every JAX-package trace costs seconds in interpret mode, so the reference
cases are few: one pass a mode of K3, one of K4, one K2 step, and K1's
down-leg, up-leg and residual-with-restriction at one sweep.
"""

import dataclasses

import numpy as np
import pytest
import torch

import openmg_tpu as jmg
from openmg_tpu.ops import fused as jfused
from openmg_tpu.ops import kernels as jk
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import kernels as tk
from openmg_tpu_torch.ops import transfer as ttr

from _torch_parity import assert_close, port_op, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

OMEGA = 2.0 / 3.0
LIN_KW = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat")
GLOBAL = (16, 8, 128)
P = 2


def cut(a, i, parts, lo, hi):
    """Slab ``i`` of ``parts`` along axis 0 of numpy ``a``, the ``lo`` last
    planes of slab i − 1 and the ``hi`` first of slab i + 1 (zeros at the
    domain edges)."""
    n = a.shape[0] // parts
    z = lambda k: np.zeros((k,) + a.shape[1:], a.dtype)  # noqa: E731
    lower = a[i * n - lo:i * n] if i > 0 else z(lo)
    upper = a[(i + 1) * n:(i + 1) * n + hi] if i < parts - 1 else z(hi)
    return a[i * n:(i + 1) * n], lower, upper


@pytest.fixture(scope="module")
def ops():
    """The constant 7-point operator of ``GLOBAL`` and a cornered 27-point
    operator of the same shape (the Galerkin level of twice the grid)."""
    h0 = jmg.setup(GLOBAL, jmg.SolverConfig(gridlevels=2, max_dense_coarse=2048, **LIN_KW)).hierarchy
    # three levels: the coarsest (8, 4, 64) keeps the dense inverse small
    h1 = jmg.setup(tuple(2 * s for s in GLOBAL), jmg.SolverConfig(gridlevels=3, max_dense_coarse=2048, **LIN_KW)).hierarchy
    A0, A1 = h0.levels[0].A, h1.levels[1].A
    assert A0.is_constant and tuple(A1.grid_shape) == GLOBAL and not A1.is_constant
    return {"const": (A0, port_op(A0)), "cornered": (A1, port_op(A1))}


K3_MODES = [("jacobi", 0), ("rbgs", 1), ("residual", 0)]


@pytest.mark.parametrize("mode,color", K3_MODES)
def test_k3_halo_matches_reference(ops, mode, color):
    Aj, At = ops["const"]
    b, x = rand(GLOBAL, 1), rand(GLOBAL, 2)
    for i in range(P):
        bs = cut(b, i, P, 0, 0)[0]
        xs, lo, hi = cut(x, i, P, 1, 1)
        ref = jk.halo_half_sweep_const_3d(
            Aj.values, Aj.offsets, to_j(bs), to_j(xs), mode, OMEGA, color,
            to_j(lo), to_j(hi))
        got = tk.halo_half_sweep_const_3d(
            At.values, At.offsets, to_t(bs), to_t(xs), mode, OMEGA, color,
            to_t(lo), to_t(hi), open_lo=int(i > 0))
        assert_close(got, ref, what=f"K3 {mode} slab {i}",
                     scale=bs if mode == "residual" else None)


@pytest.fixture(scope="module")
def cornered_reference(ops):
    """The JAX package's pass of a partitioned cornered level on two of the
    virtual CPU devices, as its ``parallel/fast.py`` smooths and takes
    residuals there: the halo kernel over the slab, then the region rows
    rewritten by ``_cornered_fix_dist`` (the axis-0 regions on the first
    device only).  All of ``K3_MODES`` in one program (one trace)."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as PS

    from openmg_tpu.ops.stencil import region_table
    from openmg_tpu.parallel import fast as jfast
    from openmg_tpu.parallel.halo import halo_planes as jplanes

    Aj, _ = ops["cornered"]
    tbl = region_table(Aj)
    b, x = rand(GLOBAL, 1), rand(GLOBAL, 2)

    def passes(bl, xl):
        lower, upper = jplanes(xl, "x", P)
        outs = []
        for mode, color in K3_MODES:
            jm = "rb" if mode == "rbgs" else mode
            xk = jfast._bulk_half_sweep(jm, Aj.values, Aj.offsets, bl, xl, OMEGA, color,
                                        lower, upper)
            outs.append(jfast._cornered_fix_dist(Aj, tbl, bl, xl, xk, jm, OMEGA, color,
                                                 lower, upper, "x", P))
        return tuple(outs)

    mesh = Mesh(np.array(jax.devices()[:P]), ("x",))
    run = jax.jit(jax.shard_map(passes, mesh=mesh, in_specs=(PS("x"), PS("x")),
                                out_specs=(PS("x"),) * len(K3_MODES), check_vma=False))
    outs = run(to_j(b), to_j(x))
    return b, x, {m: np.asarray(o) for (m, _), o in zip(K3_MODES, outs)}


@pytest.mark.parametrize("mode,color", K3_MODES)
def test_k3_halo_cornered_matches_reference(ops, cornered_reference, mode, color):
    """K3's halo form on a cornered level (the region rows in the kernel,
    the axis-0 regions kept on the first slab by ``open_lo``) against the
    JAX package's halo kernel with its fix-up pass."""
    _, At = ops["cornered"]
    b, x, ref = cornered_reference
    n = GLOBAL[0] // P
    corner = tfused._corner_info(At)
    for i in range(P):
        bs = cut(b, i, P, 0, 0)[0]
        xs, lo, hi = cut(x, i, P, 1, 1)
        got = tk.halo_half_sweep_const_3d(
            At.values, At.offsets, to_t(bs), to_t(xs), mode, OMEGA, color,
            to_t(lo), to_t(hi), corner=corner, open_lo=int(i > 0))
        assert_close(got, ref[mode][i * n:(i + 1) * n], what=f"K3 cornered {mode} slab {i}",
                     scale=bs if mode == "residual" else None)


def _vary_coeffs(shape, seed):
    """A diagonally dominant varying 7-point operator's coefficient grids,
    zero where a neighbour leaves the grid."""
    from openmg_tpu_torch.models.poisson import poisson_offsets

    offs = poisson_offsets(3)
    rng = np.random.default_rng(seed)
    c = np.empty((7,) + shape, np.float32)
    c[0] = 6.0 + rng.random(shape)
    c[1:] = -(0.5 + rng.random((6,) + shape))
    for k, off in enumerate(offs):
        for a, o in enumerate(off):
            idx = [slice(None)] * 3
            if o == -1:
                idx[a] = slice(0, 1)
            elif o == 1:
                idx[a] = slice(shape[a] - 1, shape[a])
            else:
                continue
            c[k][tuple(idx)] = 0.0
    return offs, c


def test_k4_halo_matches_reference():
    offs, c = _vary_coeffs(GLOBAL, 5)
    b, x = rand(GLOBAL, 3), rand(GLOBAL, 4)
    n = GLOBAL[0] // P
    for i in range(P):
        cs = np.ascontiguousarray(c[:, i * n:(i + 1) * n])
        bs = cut(b, i, P, 0, 0)[0]
        xs, lo, hi = cut(x, i, P, 1, 1)
        ref = jk.halo_half_sweep_vary_3d(
            to_j(cs), offs, to_j(bs), to_j(xs), "rbgs", OMEGA, 1, to_j(lo), to_j(hi))
        got = tk.halo_half_sweep_vary_3d(
            to_t(cs), offs, to_t(bs), to_t(xs), "rbgs", OMEGA, 1, to_t(lo), to_t(hi))
        assert_close(got, ref, what=f"K4 slab {i}")


def test_k2_halo_bit_equal_to_reference(ops):
    _, At = ops["const"]
    offsets = At.offsets
    terms = ((4.0, 2.0),) + ((-1.0,),) * 6
    arrs = [rand(GLOBAL, 10 + j) * s for j, s in enumerate((1, 1e-8, 1e-3, 1, 1e-8))]
    arrs = [a.astype(np.float32) for a in arrs]
    for i in range(P):
        sl = [cut(a, i, P, 1, 1) for a in arrs]
        ref = jk.df_update_residual_const_3d(
            offsets, terms, *[to_j(s[0]) for s in sl],
            halos=tuple((to_j(s[1]), to_j(s[2])) for s in sl[:3]), emit_norm=True)
        got = tk.df_update_residual_const_3d(
            offsets, terms, *[to_t(s[0]) for s in sl],
            halos=tuple((to_t(s[1]), to_t(s[2])) for s in sl[:3]), emit_norm=True)
        for j, name in enumerate(("x_hi", "x_lo", "r_hi")):
            np.testing.assert_array_equal(to_n(got[j]), np.asarray(ref[j]),
                                          err_msg=f"{name} slab {i}")
        np.testing.assert_allclose(
            float(got[3].double().sum()), float(np.asarray(ref[3])[:, 0, 0].sum()),
            rtol=1e-6)


K1_CASES = {
    # (operator, stages, emit_residual, restrict, has_x, ec)
    "down: zero start, 2 rb stages, restrict": ("const", 1, True, True, False, False),
    "up: x + P ec, 2 rb stages": ("const", 1, False, False, True, True),
    "residual + restrict, cornered": ("cornered", 0, True, True, True, False),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_halo_matches_reference(ops, case):
    kind, sweeps, er, rt, has_x, use_ec = K1_CASES[case]
    Aj, At = ops[kind]
    from openmg_tpu.ops.transfer import TRANSFERS as JT

    trj, trt = JT["linear"], ttr.TRANSFERS["linear"]
    stages = tfused.stages_for("rbgs", sweeps, OMEGA)
    depth = tfused.halo_depth(len(stages), er, rt, use_ec)
    b, x = rand(GLOBAL, 21), rand(GLOBAL, 22)
    ec = rand(tuple(s // 2 for s in GLOBAL), 23)
    jcorner = jfused._corner_info(Aj) if kind == "cornered" else None
    tcorner = tfused._corner_info(At)
    for i in range(P):
        bs, blo, bhi = cut(b, i, P, depth, depth)
        xs, xlo, xhi = cut(x, i, P, depth, depth)
        es, elo, ehi = cut(ec, i, P, depth // 2, depth // 2 + 1)
        flags = (int(i > 0), int(i < P - 1))
        kw = dict(emit_residual=er, emit_x=not (er and not stages))
        ref = jfused.fused_stages_const_3d(
            Aj.values, Aj.offsets, to_j(bs), to_j(xs) if has_x else None, stages,
            corner=jcorner, restrict_transfer=trj if rt else None,
            ec=to_j(es) if use_ec else None, prolong_transfer=trj if use_ec else None,
            halos=(to_j(np.asarray([flags], np.float32)), (to_j(blo), to_j(bhi)),
                   (to_j(xlo), to_j(xhi)) if has_x else None,
                   (to_j(elo), to_j(ehi)) if use_ec else None), **kw)
        got = tfused.fused_stages_const_3d(
            At.values, At.offsets, to_t(bs), to_t(xs) if has_x else None, stages,
            corner=tcorner, restrict_transfer=trt if rt else None,
            ec=to_t(es) if use_ec else None, prolong_transfer=trt if use_ec else None,
            halos=(flags, (to_t(blo), to_t(bhi)),
                   (to_t(xlo), to_t(xhi)) if has_x else None,
                   (to_t(elo), to_t(ehi)) if use_ec else None), **kw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        names = ("r",) if not kw["emit_x"] else ("x", "r") if er else ("x",)
        for g, r, name in zip(got, ref, names):
            assert_close(g, r, what=f"K1 {case} slab {i} {name}",
                         scale=bs if name == "r" else None)


# ---------------------------------------------------------------------------
# the plain forms over P slabs against the whole-grid plain versions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_ops():
    """Port operators on (24, 12, 20): constant 7-point and a cornered
    27-point level, built by the port alone."""
    import openmg_tpu_torch as tmg

    cfg = tmg.SolverConfig(gridlevels=3, max_dense_coarse=1 << 16, **LIN_KW)
    h = tmg.setup((48, 24, 40), cfg, device="cpu").hierarchy
    A1 = h.levels[1].A
    A0 = tmg.setup((24, 12, 20), dataclasses.replace(cfg, gridlevels=2),
                   device="cpu").hierarchy.levels[0].A
    return {"const": A0, "cornered": A1}


def _slabs(t, parts, lo, hi):
    return [tuple(map(to_t, cut(to_n(t), i, parts, lo, hi))) for i in range(parts)]


@pytest.mark.parametrize("kind", ["const", "cornered"])
@pytest.mark.parametrize("mode,color", [("jacobi", 0), ("rbgs", 0), ("rbgs", 1), ("residual", 0)])
def test_k3_plain_slabs_equal_whole_grid(port_ops, kind, mode, color):
    A = port_ops[kind]
    shape = A.grid_shape
    corner = tfused._corner_info(A)
    b, x = to_t(rand(shape, 31)), to_t(rand(shape, 32))
    whole = tk.half_sweep_plain(A.values, A.offsets, b, x, mode, OMEGA, color, corner)
    parts = 4
    got = [
        tk.halo_half_sweep_const_3d(A.values, A.offsets, bs, xs, mode, OMEGA, color,
                                    lo, hi, corner=corner, open_lo=int(i > 0))
        for i, ((bs, _, _), (xs, lo, hi)) in enumerate(
            zip(_slabs(b, parts, 0, 0), _slabs(x, parts, 1, 1)))
    ]
    assert torch.equal(torch.cat(got), whole)


def test_k3_k4_plain_2d_slabs_equal_whole_grid():
    """A 2D slab partitioned along y runs as ``(ny, 1, nx)``: its halo rows
    are the kernel's planes."""
    import openmg_tpu_torch as tmg

    A = tmg.setup((24, 20), tmg.SolverConfig(gridlevels=2, max_dense_coarse=4096, **LIN_KW),
                  device="cpu").hierarchy.levels[1].A
    shape = A.grid_shape
    corner = tfused._corner_info(A)
    b, x = to_t(rand(shape, 41)), to_t(rand(shape, 42))
    for mode, color in (("rbgs", 1), ("residual", 0)):
        whole = tk.residual_const_3d(A.values, A.offsets, b, x, corner=corner) \
            if mode == "residual" else tk.rbgs_half_sweep_const_3d(
                A.values, A.offsets, b, x, color, corner=corner)
        got = [
            tk.halo_half_sweep_const_3d(A.values, A.offsets, bs, xs, mode, OMEGA, color,
                                        lo, hi, corner=corner, open_lo=int(i > 0))
            for i, ((bs, _, _), (xs, lo, hi)) in enumerate(
                zip(_slabs(b, 3, 0, 0), _slabs(x, 3, 1, 1)))
        ]
        assert_close(torch.cat(got), whole, what=f"2D {mode}", factor=1e-6)
    coeffs = A.to_varying().coeffs
    whole = tk.rbgs_half_sweep_vary_3d(coeffs, A.offsets, b, x, 0)
    n = shape[0] // 3
    got = [
        tk.halo_half_sweep_vary_3d(coeffs[:, i * n:(i + 1) * n].contiguous(), A.offsets,
                                   bs, xs, "rbgs", OMEGA, 0, lo, hi)
        for i, ((bs, _, _), (xs, lo, hi)) in enumerate(
            zip(_slabs(b, 3, 0, 0), _slabs(x, 3, 1, 1)))
    ]
    assert_close(torch.cat(got), whole, what="2D varying", factor=1e-6)


def test_k4_plain_slabs_equal_whole_grid():
    shape = (24, 12, 20)
    offs, c = _vary_coeffs(shape, 7)
    c, b, x = to_t(c), to_t(rand(shape, 51)), to_t(rand(shape, 52))
    for mode, color in (("jacobi", 0), ("rbgs", 1), ("residual", 0)):
        whole = tk.half_sweep_vary_plain(c, offs, b, x, mode, OMEGA, color)
        n = shape[0] // 4
        got = [
            tk.halo_half_sweep_vary_3d(c[:, i * n:(i + 1) * n].contiguous(), offs, bs, xs,
                                       mode, OMEGA, color, lo, hi)
            for i, ((bs, _, _), (xs, lo, hi)) in enumerate(
                zip(_slabs(b, 4, 0, 0), _slabs(x, 4, 1, 1)))
        ]
        assert torch.equal(torch.cat(got), whole), mode


def test_k2_plain_slabs_equal_whole_grid(port_ops):
    A = port_ops["const"]
    shape = A.grid_shape
    terms = ((4.0, 2.0),) + ((-1.0,),) * 6
    arrs = [to_t(rand(shape, 60 + j) * s) for j, s in enumerate((1, 1e-8, 1e-3, 1, 1e-8))]
    whole = tk.df_update_residual_const_3d(A.offsets, terms, *arrs, emit_norm=True)
    slabs = [_slabs(a, 4, 1, 1) for a in arrs]
    got = [
        tk.df_update_residual_const_3d(
            A.offsets, terms, *[s[i][0] for s in slabs], emit_norm=True,
            halos=tuple((s[i][1], s[i][2]) for s in slabs[:3]))
        for i in range(4)
    ]
    for j in range(3):
        assert torch.equal(torch.cat([g[j] for g in got]), whole[j])
    assert torch.equal(torch.cat([g[3] for g in got]), whole[3])


@pytest.mark.parametrize("kind", ["const", "cornered"])
@pytest.mark.parametrize("visit", [
    "down: zero start, 4 rb, restrict", "down: from x, 4 rb, restrict",
    "up: x + P ec, 4 rb", "up: x + P ec, 1 jacobi", "residual + restrict",
    "3 jacobi + residual",
])
def test_k1_plain_slabs_equal_whole_grid(port_ops, kind, visit):
    A = port_ops[kind]
    shape = A.grid_shape
    tr = ttr.TRANSFERS["linear"]
    corner = tfused._corner_info(A)
    kw = {
        "down: zero start, 4 rb, restrict": dict(
            stages=tfused.stages_for("rbgs", 2, OMEGA), emit_residual=True,
            restrict_transfer=tr),
        "down: from x, 4 rb, restrict": dict(
            stages=tfused.stages_for("rbgs", 2, OMEGA), emit_residual=True,
            restrict_transfer=tr),
        "up: x + P ec, 4 rb": dict(stages=tfused.stages_for("rbgs", 2, OMEGA)),
        "up: x + P ec, 1 jacobi": dict(stages=tfused.stages_for("jacobi", 1, OMEGA)),
        "residual + restrict": dict(stages=(), emit_residual=True, restrict_transfer=tr,
                                    emit_x=False),
        "3 jacobi + residual": dict(stages=tfused.stages_for("jacobi", 3, OMEGA),
                                    emit_residual=True),
    }[visit]
    has_x = not visit.startswith("down: zero")
    use_ec = visit.startswith("up")
    b, x = to_t(rand(shape, 71)), to_t(rand(shape, 72))
    ec = to_t(rand(tuple(s // 2 for s in shape), 73))
    ekw = dict(ec=ec, prolong_transfer=tr) if use_ec else {}
    whole = tfused.fused_stages_const_3d_plain(
        A.values, A.offsets, b, x if has_x else None, corner=corner, **ekw, **kw)
    whole = whole if isinstance(whole, tuple) else (whole,)
    depth = tfused.halo_depth(len(kw["stages"]), kw.get("emit_residual", False),
                              "restrict_transfer" in kw, use_ec)
    parts = 2
    bsl, xsl = _slabs(b, parts, depth, depth), _slabs(x, parts, depth, depth)
    esl = _slabs(ec, parts, depth // 2, depth // 2 + 1)
    outs = []
    for i in range(parts):
        halos = ((int(i > 0), int(i < parts - 1)), bsl[i][1:],
                 xsl[i][1:] if has_x else None, esl[i][1:] if use_ec else None)
        got = tfused.fused_stages_const_3d(
            A.values, A.offsets, bsl[i][0], xsl[i][0] if has_x else None,
            corner=corner, halos=halos, **(dict(ec=esl[i][0], prolong_transfer=tr)
                                           if use_ec else {}), **kw)
        outs.append(got if isinstance(got, tuple) else (got,))
    for j, w in enumerate(whole):
        assert torch.equal(torch.cat([o[j] for o in outs]), w), j


def test_halo_visit_refuses_short_slabs(port_ops):
    """A visit's halo slabs must be as deep as the visit (the neighbour's
    slab at least that deep), and a halo visit is one launch."""
    A = port_ops["const"]
    b = to_t(rand(A.grid_shape, 81))
    z = torch.zeros((2,) + tuple(A.grid_shape[1:]))
    stages = tfused.stages_for("rbgs", 4, OMEGA)
    with pytest.raises(ValueError, match="one launch"):
        tfused.fused_stages_const_3d(A.values, A.offsets, b, None, stages,
                                     halos=((1, 1), (z, z), None, None))
    with pytest.raises(ValueError, match="2D or 1D"):
        tk.df_update_residual_const_3d(
            ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)), ((4.0,),) + ((-1.0,),) * 4,
            *[b[0]] * 5, halos=((b[:1, 0], b[:1, 0]),) * 3)


def test_gate_corner_drops_axis0_regions_with_one_index(port_ops):
    """A slab with a neighbour below keeps the regions off axis 0, selected
    on the table's device by one index made once and reused."""
    regions, table = tfused._corner_info(port_ops["cornered"])
    assert tfused.gate_corner((regions, table), 0) == (regions, table)
    keep = [r for r, R in enumerate(regions) if 0 not in R]
    got = [tfused.gate_corner((regions, table), 1) for _ in range(2)]
    for g_regions, g_table in got:
        assert g_regions == tuple(regions[r] for r in keep)
        assert torch.equal(g_table, table[keep])
    assert tfused._KEEP_INDEX[(tuple(keep), table.device)].tolist() == keep
