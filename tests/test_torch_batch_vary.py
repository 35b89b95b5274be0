"""The batched forms K3b and K4b (K right-hand sides in one launch, the JAX
package's ``_half_sweep`` and ``_half_sweep_vary`` under ``jax.vmap``) and
``Solver.solve_many`` as one stack in every residual mode and for every
kind of level, on the CPU.

Tolerances: K3b and K4b's batched plain versions against the vmapped
reference kernels in interpret mode, 2e-6·max|ref|
(``tests/test_torch_smoothers.py``'s: float32 sums in the same order, only
the last bits differ); against the port's scalar plain versions bit for
bit, member by member.  Each reference kernel is traced once, at K = 2.

The ``solve_many`` cases run at (8, 8, 16), V(1,1) red/black, where the
reference takes its array code: each takes the reference ``solve_many``'s
cycle counts, and every member is bit-equal to the port's scalar solve.
Each runs twice: on the CPU's own tensor code, and on the card's dispatch
(``stencil._on_cpu`` answering "not the CPU", so every residual and smoother
call goes to the kernel wrappers, which on CPU tensors run their plain
versions), where spies count the batched wrappers' calls (one for the
stack where the scalar path has one a member) and find no scalar one.
The reference's compiles set this file's time, so most cases take two
levels (a fine level that is visited and the coarsest).
"""

import numpy as np
import pytest
import torch

import jax

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.core import hierarchy as jhier
from openmg_tpu.models import poisson as jpoisson
from openmg_tpu.ops import kernels as jkernels
from openmg_tpu_torch.core import hierarchy as thier
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.ops import fused as tfused
from openmg_tpu_torch.ops import kernels as tkernels
from openmg_tpu_torch.ops import stencil as tstencil

from _torch_parity import assert_close, rand, to_j, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

K = 2
OMEGA = 2.0 / 3.0
KSHAPE = (4, 8, 128)
MODES = (("jacobi", 0), ("rbgs", 0), ("rbgs", 1), ("residual", 0))


def _stack(shape, seed, n=K):
    return np.stack([rand(shape, seed + m) for m in range(n)])


def _medium(shape, seed=12):
    return 0.5 + np.random.default_rng(seed).random(shape)


# ---------------------------------------------------------------------------
# K3b / K4b plain versions against the vmapped reference kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def passes():
    offs = tpoisson.poisson_offsets(3)
    vals = np.asarray([6.0] + [-1.0] * 6, dtype=np.float32)
    _, coeffs = tpoisson.diffusion_stencil(_medium(KSHAPE))
    return dict(offsets=offs, values=vals, coeffs=coeffs.astype(np.float32),
                b=_stack(KSHAPE, 50), x=_stack(KSHAPE, 52))


def test_k3b_plain_matches_vmapped_reference(passes):
    """A red/black pass of colour 1: the colour is each member's own
    parity, never shifted by the member's place in the stack."""
    d = passes
    O = d["offsets"]
    ref = jax.vmap(lambda bb, xx: jkernels._half_sweep(
        to_j(d["values"]), bb, xx, offsets=O, mode="rbgs", omega=0.0,
        color=1))(to_j(d["b"]), to_j(d["x"]))
    got = tkernels.half_sweep_batch(to_t(d["values"]), O, to_t(d["b"]),
                                    to_t(d["x"]), "rbgs", 0.0, 1)
    assert_close(got, to_n(ref), factor=2e-6, what="K3b rbgs")


def test_k4b_plain_matches_vmapped_reference(passes):
    d = passes
    O = d["offsets"]
    ref = jax.vmap(lambda bb, xx: jkernels._half_sweep_vary(
        to_j(d["coeffs"]), bb, xx, offsets=O, mode="jacobi", omega=OMEGA,
        color=0))(to_j(d["b"]), to_j(d["x"]))
    got = tkernels.half_sweep_vary_batch(to_t(d["coeffs"]), O, to_t(d["b"]),
                                         to_t(d["x"]), "jacobi", OMEGA)
    assert_close(got, to_n(ref), factor=2e-6, what="K4b jacobi")


# ---------------------------------------------------------------------------
# K3b / K4b plain versions against the port's scalar plain versions
# ---------------------------------------------------------------------------

LEVEL_SHAPES = {1: (64,), 2: (16, 32), 3: (8, 8, 16)}


@pytest.fixture(scope="module")
def levels():
    """The fine (constant) and the first coarse (cornered) operator of a 1D,
    2D and 3D Poisson hierarchy, and a varying operator of each dimension
    (the faced=False form of the cornered one)."""
    out = {}
    for nd, shape in LEVEL_SHAPES.items():
        cfg = tmg.SolverConfig(gridlevels=2, max_dense_coarse=4096,
                               transfer="linear")
        h = tmg.setup(shape, cfg, device="cpu").hierarchy
        hv = tmg.setup(shape, cfg, faced=False, device="cpu").hierarchy
        out[nd, "constant"] = h.levels[0].A
        out[nd, "cornered"] = h.levels[1].A
        out[nd, "varying"] = hv.levels[1].A
    return out


def _scalar_const(op, b, x, mode, color):
    corner = tfused._corner_info(op)
    if mode == "jacobi":
        return tkernels.jacobi_const_3d(op.values, op.offsets, b, x, 1, OMEGA,
                                        corner=corner)
    if mode == "rbgs":
        return tkernels.rbgs_half_sweep_const_3d(op.values, op.offsets, b, x,
                                                 color, corner=corner)
    return tkernels.residual_const_3d(op.values, op.offsets, b, x, corner=corner)


def _scalar_vary(op, b, x, mode, color):
    if mode == "jacobi":
        return tkernels.jacobi_vary_3d(op.coeffs, op.offsets, b, x, 1, OMEGA)
    if mode == "rbgs":
        return tkernels.rbgs_half_sweep_vary_3d(op.coeffs, op.offsets, b, x, color)
    return tkernels.residual_vary_3d(op.coeffs, op.offsets, b, x)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"{m[0]}{m[1]}")
@pytest.mark.parametrize("kind", ["constant", "cornered", "varying"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_batched_pass_is_the_scalar_pass_per_member(levels, nd, kind, mode):
    """K3b (constant and cornered taps) and K4b's single pass on K = 3
    members of a 1D, 2D or 3D grid (lifted as the scalar entry points lift
    it): each member bit-equal to the scalar pass on it."""
    op = levels[nd, kind]
    shape = op.grid_shape
    b, x = to_t(_stack(shape, 60, 3)), to_t(_stack(shape, 63, 3))
    m, color = mode
    w = OMEGA if m == "jacobi" else 0.0
    if kind == "varying":
        got = tkernels.half_sweep_vary_batch(op.coeffs, op.offsets, b, x, m, w, color)
        one = _scalar_vary
    else:
        got = tkernels.half_sweep_batch(op.values, op.offsets, b, x, m, w, color,
                                        tfused._corner_info(op))
        one = _scalar_const
    assert got.shape == b.shape
    for k in range(3):
        assert torch.equal(got[k], one(op, b[k], x[k], m, color)), k


LEGS = [(4, "rbgs", True, False), (4, "rbgs", False, True),
        (2, "jacobi", True, True), (1, "jacobi", True, False), (0, "rbgs", True, True)]


@pytest.mark.parametrize("leg", LEGS, ids=lambda c: f"{c[0]}{c[1]}-r{int(c[2])}-x{int(c[3])}")
@pytest.mark.parametrize("nd", [2, 3])
def test_batched_leg_is_the_scalar_leg_per_member(levels, nd, leg):
    """K4b's legs (``sweeps_vary_batch``) from zero or from x, with and
    without the residual: each member bit-equal to ``sweeps_vary_3d`` on
    it."""
    op = levels[nd, "varying"]
    shape = op.grid_shape
    passes, mode, res, from_x = leg
    b, x = to_t(_stack(shape, 70, 3)), to_t(_stack(shape, 73, 3))
    inv = 1.0 / op.coeffs[tstencil.diag_index(op.offsets)]
    got = tkernels.sweeps_vary_batch(op.coeffs, op.offsets, b, x if from_x else None,
                                     passes, mode, OMEGA, res, inv)
    for k in range(3):
        one = tkernels.sweeps_vary_3d(op.coeffs, op.offsets, b[k],
                                      x[k] if from_x else None, passes, mode,
                                      OMEGA, res, inv)
        for g, o in zip(got if res else (got,), one if res else (one,)):
            assert torch.equal(g[k], o), k


def test_batched_stencil_wrappers_count_nothing_on_the_cpu(levels):
    before = (tkernels.LAUNCHES_K3_BATCH, tkernels.LAUNCHES_K4_BATCH)
    op, vop = levels[3, "cornered"], levels[3, "varying"]
    b = to_t(_stack(op.grid_shape, 80))
    tkernels.half_sweep_batch(op.values, op.offsets, b, b, "residual",
                              corner=tfused._corner_info(op))
    tkernels.half_sweep_vary_batch(vop.coeffs, vop.offsets, b, b, "rbgs", 0.0, 1)
    tkernels.sweeps_vary_batch(vop.coeffs, vop.offsets, b, None, 4, "rbgs",
                               emit_residual=True)
    assert (tkernels.LAUNCHES_K3_BATCH, tkernels.LAUNCHES_K4_BATCH) == before


def test_batched_stencil_wrappers_refuse_before_launching(levels, monkeypatch):
    """Malformed batches are refused by the wrappers' checks, which run
    before a kernel is built or launched (so here, on CPU tensors); on a
    tensor that is not on the CPU the wrappers never run a plain version."""
    op, vop = levels[3, "constant"], levels[3, "varying"]
    O, V, C = op.offsets, op.values, vop.coeffs
    b = to_t(_stack(op.grid_shape, 90, 3))
    with pytest.raises(ValueError, match="batches"):
        tkernels._half_sweep_cuda(V, O, b[0], b[0], "residual", 0.0, 0, False,
                                  None, batch=True)
    # a batch's halos are every member's planes, (K, 1, ny, nx)
    with pytest.raises(ValueError, match="lower halo has shape"):
        tkernels._half_sweep_cuda(V, O, b, b, "residual", 0.0, 0, False, None,
                                  halos=(b[:1, 0], b[:1, 0]), batch=True)
    with pytest.raises(ValueError, match="shape"):
        tkernels._half_sweep_cuda(C, O, b[:2], b, "jacobi", OMEGA, 0, True, None,
                                  batch=True)
    with pytest.raises(TypeError, match="tensor"):
        tkernels._half_sweep_cuda(V, O, b.numpy(), b, "residual", 0.0, 0, False,
                                  None, batch=True)
    with pytest.raises(ValueError, match="float32"):
        tkernels._vary_leg_cuda(C, O, b.double(), None, 2, "rbgs", 0.0, True, 0,
                                batch=True)
    with pytest.raises(ValueError, match="batches"):
        tkernels._vary_leg_cuda(C, O, b[0], None, 2, "rbgs", 0.0, True, 0,
                                batch=True)
    with pytest.raises(ValueError, match="shape"):
        tkernels._vary_leg_cuda(C, O, b, b[:1], 2, "rbgs", 0.0, True, 0, batch=True)
    # the public forms: a grid of the operator's dimension is not a batch
    with pytest.raises(ValueError, match=r"\(K, \*grid\)"):
        tkernels.half_sweep_batch(V, O, b[0], b[0], "residual")
    with pytest.raises(ValueError, match="operand"):
        tkernels.half_sweep_vary_batch(C, O, b, b[:2], "residual")
    with pytest.raises(ValueError, match=r"\(K, \*grid\)"):
        tkernels.sweeps_vary_batch(C, O, b[0], None, 2)
    called = []
    for name in ("half_sweep_plain", "half_sweep_vary_plain", "sweeps_vary_plain",
                 "half_sweep_batch_plain", "half_sweep_vary_batch_plain",
                 "sweeps_vary_batch_plain"):
        monkeypatch.setattr(tkernels, name, lambda *a, **k: called.append(1))
    meta = torch.empty((3,) + op.grid_shape, dtype=torch.float32, device="meta")
    cmeta = torch.empty(tuple(C.shape), dtype=torch.float32, device="meta")
    for call in (
        lambda: tkernels.half_sweep_batch(V.to("meta"), O, meta, meta, "residual"),
        lambda: tkernels.half_sweep_vary_batch(cmeta, O, meta, meta, "jacobi", OMEGA),
        lambda: tkernels.sweeps_vary_batch(cmeta, O, meta, None, 4, emit_residual=True),
    ):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert not called


def test_a_2d_batch_reaches_the_2d_lift_not_a_3d_grid(levels, monkeypatch):
    """A batch of planes has the shape of a 3D grid: ``residual`` decides by
    the operator's dimension, so the batch reaches K3b on its lift."""
    op = levels[2, "cornered"]
    b, x = to_t(_stack(op.grid_shape, 95)), to_t(_stack(op.grid_shape, 97))
    seen = []
    real = tkernels.half_sweep_batch

    def spy(*a, **k):
        seen.append(len(a[1][0]))
        return real(*a, **k)

    monkeypatch.setattr(tkernels, "half_sweep_batch", spy)
    monkeypatch.setattr(tstencil, "_on_cpu", lambda t: False)
    r = tstencil.residual(op, b, x)
    monkeypatch.undo()
    assert seen == [2]
    want = torch.stack([tstencil.residual(op, b[k], x[k]) for k in range(K)])
    assert_close(r, want, factor=2e-6, scale=b, what="2D batch residual")


# ---------------------------------------------------------------------------
# solve_many: one stack in every residual mode and on every kind of level
# ---------------------------------------------------------------------------

MANY_SHAPE = (8, 8, 16)
BASE = dict(pre_iterations=1, post_iterations=1, smoother="rbgs",
            transfer="linear", residual_dtype="doublefloat", gridlevels=2,
            max_dense_coarse=512, cycles=60)
# (settings, problem, level kind of the visited coarse levels)
CASES = {
    "diffusion": (dict(), "diffusion", None),
    "unfaced": (dict(gridlevels=3), "poisson", "varying"),
    "faced": (dict(gridlevels=3), "poisson", "faced"),
    "chebyshev": (dict(smoother="chebyshev"), "poisson", None),
    "float32": (dict(residual_dtype="float32", threshold=1e-5), "poisson", None),
    "pcg": (dict(krylov="pcg", krylov_iters=2), "poisson", None),
    "fmg": (dict(cycle_type="f"), "poisson", None),
}


def _problem(name, pkg):
    if name == "poisson":
        return MANY_SHAPE
    models = tpoisson if pkg is tmg else jpoisson
    return models.diffusion_stencil(_medium(MANY_SHAPE))


def _rhs():
    rhs = [np.random.default_rng(s).standard_normal(MANY_SHAPE) for s in (1, 2, 3)]
    rhs[1] = rhs[1] * 1e-3  # converges first: the stack narrows
    return rhs


def _setup(pkg, case, monkeypatch):
    """``pkg``'s solver of ``case``; a faced case reclassifies the cornered
    levels (a Poisson setup never classifies one as faced)."""
    kw, prob, kind = CASES[case]
    cfg = pkg.SolverConfig(**{**BASE, **kw})
    faced = kind != "varying"
    if pkg is tmg:
        with monkeypatch.context() as m:
            if kind == "faced":
                real = thier.classify_level

                def faced_level(offsets, rep):
                    k, payload = real(offsets, rep)
                    if k != "cornered":
                        return k, payload
                    return "faced", thier.detect_faced(offsets, rep)

                m.setattr(thier, "classify_level", faced_level)
            return tmg.setup(_problem(prob, tmg), cfg, faced=faced, device="cpu")
    with monkeypatch.context() as m:
        if kind == "faced":
            m.setattr(jhier, "detect_cornered", lambda *a, **k: None)
        return jmg.setup(_problem(prob, jmg), cfg, faced=faced)


_REF = {}


def _reference_cycles(case, monkeypatch):
    """The reference ``solve_many``'s cycle counts, computed once a case."""
    if case not in _REF:
        solver = _setup(jmg, case, monkeypatch)
        _REF[case] = solver.solve_many(_rhs())[1]["cycles"]
    return _REF[case]


SPIED = {
    "K1b": (tfused, "fused_stages_const_3d_batch"),
    "K2b": (tkernels, "df_update_residual_batch"),
    "K3b": (tkernels, "half_sweep_batch"),
    "K4b pass": (tkernels, "half_sweep_vary_batch"),
    "K4b leg": (tkernels, "sweeps_vary_batch"),
    "K1": (tfused, "fused_stages_const_3d"),
    "K2": (tkernels, "df_update_residual_const_3d"),
    "K3": (tkernels, "_half_sweep"),
    "K4 pass": (tkernels, "_half_sweep_vary"),
    "K4 leg": (tkernels, "sweeps_vary_3d"),
}


def _spies(monkeypatch):
    calls = {k: 0 for k in SPIED}
    for key, (mod, name) in SPIED.items():
        real = getattr(mod, name)

        def spy(*a, _key=key, _real=real, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


def _want_calls(case, solver, steps):
    """The wrapper calls of ``steps`` outer steps of the batch: one for the
    stack wherever a scalar step makes one a member (V(1,1), one
    red/black sweep = two passes)."""
    h = solver.hierarchy
    want = {k: 0 for k in SPIED}
    inner = 2 if case == "pcg" else 1
    for L in h.levels[:-1]:
        if isinstance(L.A, tstencil.FacedStencilOperator):
            want["K3b"] += 5 * inner * steps  # 2 + 2 passes and the residual
        elif isinstance(L.A, tstencil.StencilOperator) and not L.A.is_constant:
            want["K4b leg"] += 2 * inner * steps
        elif case == "chebyshev":
            want["K3b"] += 3 * inner * steps  # pre, post and the residual
        else:
            want["K1b"] += 2 * inner * steps
    if case == "float32":
        want["K3b"] += steps + 1  # the outer residual, the start's too
    elif case != "diffusion":
        want["K2b"] += steps
    return want


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_many_runs_one_stack(case, route, monkeypatch):
    """The reference's ``solve_many`` cycle counts; every member's iterate
    and norm history bit-equal to its scalar solve; one host read a step;
    on the card's route one batched wrapper call for the stack where the
    scalar path makes one a member, and no scalar one."""
    want_cycles = _reference_cycles(case, monkeypatch)
    solver = _setup(tmg, case, monkeypatch)
    kind = CASES[case][2]
    if kind is not None:
        assert all(isinstance(L.A, tstencil.FacedStencilOperator) if kind == "faced"
                   else not L.A.is_constant for L in solver.hierarchy.levels[1:-1])
    if route == "card":
        monkeypatch.setattr(tstencil, "_on_cpu", lambda t: False)
    rhs = _rhs()
    scalar = [solver.solve(b) for b in rhs]
    calls = _spies(monkeypatch)
    xs, info = solver.solve_many(rhs)
    steps = max(info["cycles"])
    assert info["cycles"] == want_cycles
    assert info["cycles"][1] < info["cycles"][0]
    assert info["host_reads"] == steps + 1
    for k, (xk, ik) in enumerate(scalar):
        np.testing.assert_array_equal(xs[k], xk)
        assert info["residual_norms"][k] == ik["residual_norms"]
        assert info["converged"][k]
    if route == "card":
        assert calls == _want_calls(case, solver, steps)


@pytest.mark.parametrize("case", ["diffusion", "float32"])
def test_solve_many_initial_guesses_and_device_batch(case, monkeypatch):
    """``x0s`` (one member without) and a float32 tensor batch: each member
    bit-equal to the scalar solve of the same input."""
    solver = _setup(tmg, case, monkeypatch)
    rhs = _rhs()
    x0s = [None, rhs[1] * 0.1, rhs[2] * 0.1]
    xs, info = solver.solve_many(rhs, x0s=x0s)
    for k in range(3):
        xk, ik = solver.solve(rhs[k], x0=x0s[k])
        np.testing.assert_array_equal(xs[k], xk)
        assert info["cycles"][k] == ik["cycles"]
    bs = torch.from_numpy(np.stack(rhs).astype(np.float32))
    xd, idn = solver.solve_many(bs)
    assert isinstance(xd, torch.Tensor) and xd.dtype == torch.float32
    for k in range(3):
        xk, ik = solver.solve(bs[k].clone())
        assert torch.equal(xd[k], xk) and idn["cycles"][k] == ik["cycles"]
