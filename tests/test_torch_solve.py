"""The slice as a whole: the port's 3D Poisson defect-correction solve on
the CPU against one solve of the JAX package (Pallas in interpret mode),
and one V-cycle with the setup held equal.

The reference solve is traced once (module-scoped fixture); it dominates
this file's time.  It runs the JAX package's host outer loop
(``outer_loop="host"``): the same cycle and residual programs, compiled
about 10 s faster than its whole-solve device program.
"""

import numpy as np
import pytest
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu_torch.core import cycle as tcycle
from openmg_tpu_torch.core import hierarchy as thier
from openmg_tpu_torch.utils.convert import hierarchy_from_numpy

from _torch_parity import assert_close, rand, spec_from_jax_hierarchy, to_n, to_t
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

SHAPE = (32, 32, 64)
CFG_KW = dict(
    smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
    gridlevels=3, max_dense_coarse=1024,
)


def _rhs():
    b = tmg.rhs_random(SHAPE, seed=0)
    return b / np.linalg.norm(b.ravel())


@pytest.fixture(scope="module")
def reference():
    solver = jmg.setup(SHAPE, jmg.SolverConfig(outer_loop="host", **CFG_KW))
    x, info = solver.solve(_rhs())
    return solver, np.asarray(x), info


@pytest.fixture(scope="module")
def port():
    solver = tmg.setup(SHAPE, tmg.SolverConfig(**CFG_KW), device="cpu")
    x, info = solver.solve(_rhs())
    return solver, x, info


def test_solve_matches_reference_history(reference, port):
    _, _, ri = reference
    _, x, pi = port
    assert isinstance(x, np.ndarray) and x.dtype == np.float64 and x.shape == SHAPE
    assert pi["converged"] and ri["converged"]
    assert pi["cycles"] == ri["cycles"] == 7
    assert len(pi["residual_norms"]) == len(ri["residual_norms"])
    for k, (a, b) in enumerate(zip(pi["residual_norms"], ri["residual_norms"])):
        # the f32 cycles round differently; entries below 1e-9 sit near the
        # double-float floor ‖A‖·‖x‖·2⁻⁴⁹, where the last bits decide more
        bound = 1.5 if b < 1e-9 else 1.1
        assert b / bound <= a <= b * bound, (k, a, b)
    assert pi["final_norm"] == pi["residual_norms"][-1] < 1e-10


def test_solve_info_keys(reference, port):
    _, _, ri = reference
    _, _, pi = port
    for key in ("residual_norms", "cycles", "converged", "final_norm",
                "gridlevels", "level_stats", "transfer", "residual_mode",
                "solve_time_s"):
        assert key in pi, key
    assert pi["gridlevels"] == ri["gridlevels"] == 3
    assert pi["level_stats"] == tuple(ri["level_stats"])
    assert pi["transfer"] == ri["transfer"] == "linear"
    assert pi["residual_mode"] == ri["residual_mode"] == "doublefloat"


def test_solution_residual_in_float64(port):
    _, x, _ = port
    A = tmg.poisson(SHAPE)
    r = _rhs().ravel() - A @ x.ravel()
    assert np.linalg.norm(r) < 1e-10 * 1.05


def test_solution_matches_reference(reference, port):
    """Both solutions are within the threshold of the same exact solution,
    so they differ by at most 2e-10 / λ_min(A)."""
    _, xr, _ = reference
    _, xp, _ = port
    lam_min = sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in SHAPE)
    assert np.linalg.norm((xp - xr).ravel()) <= 2e-10 / lam_min


def test_v_cycle_with_equal_setup(reference):
    """The reference hierarchy carried across as numpy; one V(2,2) cycle of
    each side on the same right-hand side.  5e-6·max|ref|: two level visits
    and a dense coarse solve, each within the kernels' 2e-6.

    The reference cycle is its solver's first outer step, which reuses the
    program the fixture's solve compiled: a right-hand side of norm just
    above the threshold converges after exactly one cycle from the zero
    iterate, and the solution is then the cycle's output, exactly (the
    double-float sum 0 + e)."""
    solver = reference[0]
    hj = solver.hierarchy
    ht = hierarchy_from_numpy(spec_from_jax_hierarchy(hj), "cpu")
    assert [L.grid_shape for L in ht.levels] == [tuple(L.grid_shape) for L in hj.levels]
    # ‖rand‖ ≈ 256, so ‖r‖ ≈ 1.16e-10; the power of two keeps float32 exact
    r = rand(SHAPE, 3) * np.float32(2.0 ** -41)
    assert 1e-10 < np.linalg.norm(r.astype(np.float64)) < 2e-10
    want, info = solver.solve(r.astype(np.float64))
    assert info["cycles"] == 1 and info["converged"]
    got = tcycle.run_cycle(ht, to_t(r), "v", 2, 2, "rbgs", 2.0 / 3.0)
    assert_close(got, np.asarray(want), factor=5e-6, what="v_cycle")


def test_v_cycle_x_zero_flag_is_sound(port):
    h = port[0].hierarchy
    r = to_t(rand(SHAPE, 4))
    fast = tcycle.v_cycle(h, r, None, x_zero=True)
    slow = tcycle.v_cycle(h, r, torch.zeros_like(r), x_zero=False)
    assert_close(fast, slow, factor=1e-6)
    with pytest.raises(ValueError):
        tcycle.v_cycle(h, r, None, x_zero=False)


def test_f32_tensor_rhs_is_delivered_on_the_device(port):
    solver = port[0]
    b = torch.from_numpy(_rhs().astype(np.float32))
    x, info = solver.solve(b)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
    assert x.device == b.device and tuple(x.shape) == SHAPE
    hi, lo = info["x_df"]
    assert x is hi and lo.dtype == torch.float32
    assert info["converged"] and info["cycles"] == 7
    # the pair, merged on the host, solves the float32 right-hand side
    xm = to_n(hi).astype(np.float64) + to_n(lo).astype(np.float64)
    r = to_n(b).astype(np.float64).ravel() - tmg.poisson(SHAPE) @ xm.ravel()
    assert np.linalg.norm(r) < 1e-10 * 1.05


def test_x0_and_flat_rhs(port):
    solver, x, _ = port
    x2, info = solver.solve(_rhs().ravel(), x0=x)
    assert info["cycles"] == 0 and info["converged"]
    np.testing.assert_array_equal(x2, x)


def test_mg_solve_default_parameters():
    shape = (8, 8, 16)
    b = tmg.rhs_random(shape, seed=2)
    b /= np.linalg.norm(b)
    params = {"problemshape": shape, "gridlevels": 2, "max_dense_coarse": 128}
    x, info = tmg.mg_solve(None, b.ravel(), params, device="cpu")
    assert x.shape == (b.size,) and info["converged"]
    assert info["transfer"] == "aggregate"
    assert np.linalg.norm(b.ravel() - tmg.poisson(shape) @ x) < 1e-10 * 1.05
    xs, _ = tmg.solve(shape, b, tmg.SolverConfig(gridlevels=2, max_dense_coarse=128),
                      device="cpu")
    np.testing.assert_array_equal(xs.ravel(), x)


@pytest.mark.parametrize("call", ["setup", "solve", "mg_solve"])
def test_entry_points_need_cuda_unless_cpu_is_named(call):
    """No entry point chooses the CPU by itself."""
    assert not torch.cuda.is_available(), "this test describes a CPU-only machine"
    b = np.ones((4, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "setup":
            tmg.setup((4, 4, 4))
        elif call == "solve":
            tmg.solve((4, 4, 4), b)
        else:
            tmg.mg_solve(None, b, {"problemshape": (4, 4, 4)})


def test_cuda_tensor_never_reaches_a_plain_version(monkeypatch):
    """The wrappers choose by the tensor's device alone: for a tensor that
    is not on the CPU they go for the kernel (here: fail to build it)
    instead of running the plain version."""
    from openmg_tpu_torch.ops import fused, kernels

    meta = torch.empty((4, 4, 4), dtype=torch.float32, device="meta")
    vals = torch.empty((7,), dtype=torch.float32, device="meta")
    offs = tmg.models.poisson.poisson_offsets(3)
    called = []
    monkeypatch.setattr(
        fused, "fused_stages_const_3d_plain", lambda *a, **k: called.append(1)
    )
    monkeypatch.setattr(
        kernels, "df_update_residual_const_3d_plain", lambda *a, **k: called.append(1)
    )
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_stages_const_3d(vals, offs, meta, meta, (("rb", 0),))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.df_update_residual_const_3d(
            offs, ((4.0, 2.0),) + ((-1.0,),) * 6, meta, meta, meta, meta, meta
        )
    assert not called


STUB_CONFIGS = [
    dict(smoother="chebyshev"),
    dict(dtype="float64"),
]


@pytest.mark.parametrize("kw", STUB_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_unported_configurations_raise(kw):
    """The Chebyshev smoother and the float64 cycle, refused before they
    were ported, set up and solve on the CPU; on the card a float64 cycle
    is still refused (the stencil kernels are float32)."""
    shape = (4, 4, 8)
    cfg = tmg.SolverConfig(**{**dict(gridlevels=2, max_dense_coarse=64), **kw})
    b = tmg.rhs_random(shape, seed=4)
    solver = tmg.setup(shape, cfg, device="cpu")
    x, info = solver.solve(b)
    assert info["converged"] and x.shape == shape
    assert np.linalg.norm(b.ravel() - tmg.poisson(shape) @ x.ravel()) < 1e-10 * 1.05
    if "dtype" in kw:
        assert solver.hierarchy.levels[0].A.dtype == torch.float64
        assert info["residual_mode"] == "float64"
        with pytest.raises(NotImplementedError, match="float32"):
            tmg.setup(shape, cfg, device="meta")


CYCLE_CONFIGS = [
    dict(krylov="pcg"),
    dict(cycle_type="w"),
    dict(cycle_type="f"),
]


@pytest.mark.parametrize("kw", CYCLE_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_cycle_configurations_set_up_and_solve(kw):
    """PCG, W and FMG, refused before they were ported, set up and solve."""
    shape = (4, 4, 8)
    cfg = tmg.SolverConfig(**{**dict(gridlevels=2, max_dense_coarse=64), **kw})
    b = tmg.rhs_random(shape, seed=4)
    x, info = tmg.setup(shape, cfg, device="cpu").solve(b)
    assert info["converged"] and x.shape == shape
    assert np.linalg.norm(b.ravel() - tmg.poisson(shape) @ x.ravel()) < 1e-10 * 1.05


@pytest.mark.parametrize("rdtype", ["float64", "float32", None])
def test_plain_residual_configurations_set_up(rdtype):
    """The plain residual modes keep one fine operator in that type (None:
    the cycle's float32) and no lo part."""
    cfg = tmg.SolverConfig(gridlevels=2, max_dense_coarse=64, residual_dtype=rdtype)
    solver = tmg.setup((4, 4, 8), cfg, device="cpu")
    want = torch.float64 if rdtype == "float64" else torch.float32
    assert solver.residual_mode == want
    assert solver.hierarchy.fine_hi.dtype == want and solver.hierarchy.fine_hi_lo is None
    with pytest.raises(ValueError, match="residual_dtype"):
        tmg.setup((4, 4, 8), tmg.SolverConfig(residual_dtype="bfloat16"), device="cpu")


def test_float32_residual_solve_follows_the_reference_history(reference):
    """The (32,32,64) solve with a float32 outer residual, to a threshold
    that residual can reach: above its rounding floor the history does not
    depend on the residual's precision, so it follows the reference's
    double-float history cycle for cycle and stops at the first entry below
    the threshold."""
    threshold = 1e-5
    ref = reference[2]["residual_norms"]
    want_cycles = next(k for k, r in enumerate(ref) if r < threshold)
    cfg = tmg.SolverConfig(**{**CFG_KW, "residual_dtype": "float32",
                              "threshold": threshold})
    x, info = tmg.setup(SHAPE, cfg, device="cpu").solve(_rhs())
    assert info["converged"] and info["residual_mode"] == "float32"
    assert info["cycles"] == want_cycles == 4
    for a, r in zip(info["residual_norms"], ref):
        # the last entry sits near the float32 rounding floor
        bound = 1.1 if r >= threshold else 1.5
        assert r / bound <= a <= r * bound
    res = _rhs().ravel() - tmg.poisson(SHAPE) @ x.ravel()
    assert np.linalg.norm(res) < 1.5 * threshold


def test_unported_entry_points_raise(port, tmp_path):
    """Every entry point refused before it was ported runs now:
    checkpoint/resume (a checkpointed solve gives the same x; ``resume``
    without a file is a plain solve, as in the JAX package),
    ``solve_many``, the W and F cycles and PCG."""
    from openmg_tpu_torch.ops.stencil import apply

    solver, x_port, info_port = port
    h = solver.hierarchy
    r = to_t(rand(SHAPE, 8))
    xs, info = solver.solve_many([_rhs()])
    np.testing.assert_array_equal(xs[0], x_port)
    assert info["cycles"] == [info_port["cycles"]]
    xc, ic = solver.solve(_rhs(), checkpoint_path=tmp_path / "ckpt.npz")
    np.testing.assert_array_equal(xc, x_port)
    assert ic["cycles"] == info_port["cycles"] and (tmp_path / "ckpt.npz").exists()
    xr, _ = solver.solve(_rhs(), resume=True)
    np.testing.assert_array_equal(xr, x_port)
    w = tcycle.run_cycle(h, r, "w")
    assert torch.equal(w, tcycle.v_cycle(h, r, None, gamma=2, x_zero=True))
    assert torch.equal(tcycle.run_cycle(h, r, "f"), tcycle.fmg_cycle(h, r))
    with pytest.raises(ValueError):
        tcycle.run_cycle(h, r, "z")
    # one CG step is the preconditioned residual scaled by the exact step
    # length; a second step lowers the energy ½ eᵀAe − eᵀr (the A-norm
    # error up to a constant) further
    z = tcycle.run_cycle(h, r, "v")
    e1 = tcycle.pcg_solve(h, r, 1)
    alpha = torch.sum(r * z) / torch.sum(z * apply(h.levels[0].A, z))
    assert_close(e1, alpha * z, factor=1e-6, what="one CG step")
    A = tmg.poisson(SHAPE)
    r64 = to_n(r).astype(np.float64).ravel()

    def energy(e):
        e = to_n(e).astype(np.float64).ravel()
        return 0.5 * float(e @ (A @ e)) - float(e @ r64)

    assert energy(tcycle.pcg_solve(h, r, 2)) < energy(e1) < 0
    # the sparse engine takes a sparse format, PCG and FMG
    _, info = tmg.mg_solve(None, np.ones(64), {"problemshape": (4, 4, 4),
                                               "format": "ell"}, device="cpu")
    assert info["format"] == "ell" and info["converged"]
    for kw in ({"krylov": "pcg"}, {"cycle_type": "f"}):
        A4 = tmg.poisson((4, 4, 4))
        xi, ii = tmg.mg_solve(A4, np.ones(64),
                              {"problemshape": (4, 4, 4), "format": "ell",
                               "gridlevels": 2, "max_dense_coarse": 8, **kw},
                              device="cpu")
        assert ii["converged"] and ii["format"] == "ell" and ii["gridlevels"] == 2
        assert np.linalg.norm(np.ones(64) - A4 @ xi) < 1e-10 * 1.05
    with pytest.raises(ValueError):
        tmg.mg_solve(None, np.ones(64), {}, device="cpu")


def test_stencil_pair_and_matrix_entry_points_work():
    """What used to be refused: ``setup`` from an ``(offsets, coeffs)`` pair
    and ``mg_solve`` with a matrix give the grid-shape solve's answer."""
    import scipy.sparse as sp

    shape = (4, 4, 8)
    cfg = tmg.SolverConfig(gridlevels=2, max_dense_coarse=64)
    b = tmg.rhs_random(shape, seed=5)
    x_shape, i_shape = tmg.solve(shape, b, cfg, device="cpu")
    x_pair, i_pair = tmg.solve(tmg.poisson_stencil(shape), b, cfg, device="cpu")
    assert i_pair["converged"] and i_pair["cycles"] == i_shape["cycles"]
    np.testing.assert_allclose(x_pair, x_shape, rtol=0, atol=1e-9)
    x_mat, i_mat = tmg.mg_solve(
        tmg.poisson(shape), b, {"problemshape": shape, "gridlevels": 2,
                                "max_dense_coarse": 64}, device="cpu")
    assert i_mat["converged"]
    # the extracted stencil lists its offsets in another order
    np.testing.assert_allclose(x_mat, x_pair.ravel(), rtol=0, atol=1e-9)
    xi, ii = tmg.mg_solve(sp.identity(128, format="csr"), b.ravel(),
                          {"problemshape": shape, "gridlevels": 2,
                           "max_dense_coarse": 64}, device="cpu")
    assert ii["converged"]
    np.testing.assert_allclose(xi, b.ravel(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape", [(32, 32), (64,)])
def test_unported_grid_dimensions_raise(shape):
    """1D and 2D grids, refused before their paths were ported, now set up
    and solve."""
    cfg = tmg.SolverConfig(gridlevels=2, max_dense_coarse=512)
    b = tmg.rhs_random(shape, seed=1)
    x, info = tmg.setup(shape, cfg, device="cpu").solve(b)
    assert info["converged"] and x.shape == shape
    assert np.linalg.norm(b.ravel() - tmg.poisson(shape) @ x.ravel()) < 1e-10 * 1.05


@pytest.mark.parametrize("pre,post", [(2, 0), (0, 2), (0, 0)])
def test_v_cycle_without_pre_or_post_sweeps(port, monkeypatch, pre, post):
    """Zero sweeps on a leg still go through the fused function (its
    stage-free modes), and equal the composition of the separate ones."""
    from openmg_tpu_torch.ops import fused
    from openmg_tpu_torch.ops.smoothers import smooth
    from openmg_tpu_torch.ops.stencil import residual
    from openmg_tpu_torch.ops.transfer import prolong, restrict

    h = port[0].hierarchy
    r = to_t(rand(SHAPE, 5))
    calls = []
    real = fused.fused_stages_const_3d

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused, "fused_stages_const_3d", counted)
    got = tcycle.v_cycle(h, r, None, pre=pre, post=post, x_zero=True)
    assert len(calls) == 2 * (h.num_levels - 1)

    def composed(level, b):
        L = h.levels[level]
        if level == h.num_levels - 1:
            return tcycle.coarse_solve(h, b)
        x = smooth("rbgs", L.A, L.inv_diag, b, torch.zeros_like(b), pre, 2.0 / 3.0)
        ec = composed(level + 1, restrict(residual(L.A, b, x), h.transfer))
        x = x + prolong(ec, L.grid_shape, h.transfer)
        return smooth("rbgs", L.A, L.inv_diag, b, x, post, 2.0 / 3.0)

    assert_close(got, composed(0, r), factor=5e-6, what=f"V({pre},{post})")


def test_card_refuses_what_the_kernel_does_not_take(port, monkeypatch):
    """Where a fused entry point declines a visit, the visit is composed of
    ``smooth`` and ``residual``.  Off the CPU those go to the per-pass
    kernel's entry points, never to the plain tensor code, and refuse what
    that kernel does not take (a float64 cycle)."""
    from openmg_tpu_torch.ops import fused, kernels, smoothers, stencil

    h = port[0].hierarchy
    r = to_t(rand(SHAPE, 6))
    want = tcycle.v_cycle(h, r, None, x_zero=True)
    for name in ("presmooth_restrict_fused", "prolong_smooth_fused"):
        with monkeypatch.context() as m:
            m.setattr(fused, name, lambda *a, **k: None)
            m.setattr(fused, "smooth_fused", lambda *a, **k: None)
            m.setattr(fused, "residual_restrict_fused", lambda *a, **k: None)
            composed = tcycle.v_cycle(h, r, None, x_zero=True)  # CPU: plain
            assert_close(composed, want, factor=5e-6)
            m.setattr(stencil, "_on_cpu", lambda t: False)
            for plain in ("jacobi", "rbgs"):
                m.setattr(smoothers, plain,
                          lambda *a, **k: pytest.fail("plain smoother off the CPU"))
            passes = []
            real = kernels._half_sweep

            def counted(*a, **k):
                passes.append(k["mode"])
                return real(*a, **k)

            m.setattr(kernels, "_half_sweep", counted)
            got = tcycle.v_cycle(h, r, None, x_zero=True)
            assert passes and set(passes) <= {"rbgs", "residual"}
            assert_close(got, want, factor=5e-6)
            with pytest.raises(NotImplementedError, match="float32"):
                tcycle.v_cycle(h, r.double(), None, x_zero=True)


@pytest.mark.parametrize("kind", ["faced", "varying"])
def test_unported_level_kinds_raise(monkeypatch, kind):
    """Neither kind is refused any more.  A level that classifies as faced
    is stored as a ``FacedStencilOperator``, a varying one as coefficient
    grids (the structured setup's ``faced=False`` form): the cornered
    levels reclassified either way give the operators of their
    ``to_varying``."""
    from openmg_tpu_torch.ops.stencil import FacedStencilOperator

    real = thier.classify_level

    def fake(offsets, rep):
        k, payload = real(offsets, rep)
        if k != "cornered":
            return k, payload
        return kind, (thier.detect_faced(offsets, rep) if kind == "faced" else None)

    cfg = tmg.SolverConfig(**CFG_KW)
    want = tmg.setup(SHAPE, cfg, device="cpu").hierarchy
    monkeypatch.setattr(thier, "classify_level", fake)
    got = tmg.setup(SHAPE, cfg, device="cpu").hierarchy
    if kind == "faced":
        assert all(isinstance(L.A, FacedStencilOperator) for L in got.levels[1:])
        for L, W in zip(got.levels[1:], want.levels[1:]):
            assert torch.equal(L.A.to_varying().coeffs, W.A.to_varying().coeffs)
        return
    assert [L.A.is_constant for L in got.levels] == [True] + [False] * (
        got.num_levels - 1)
    for L, W in zip(got.levels[1:], want.levels[1:]):
        assert_close(L.A.coeffs, W.A.to_varying().coeffs, factor=1e-7,
                     what="varying level")
