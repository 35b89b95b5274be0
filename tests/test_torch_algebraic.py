"""The general sparse engine of the port on the CPU against the JAX package:
the colourings, the hierarchy arrays, one cycle on a carried-over
hierarchy, whole solves (ELL, BSR at block sizes 2, 3 and 4, CSR and dense
through ``mg_solve``), ``mg_solve``'s fallback for a matrix that is not
stencil-representable, and the refusals of what waits for later slices.

Inputs come from numpy seeds and go to both packages.  The reference solves
sit in module-scoped fixtures.  Two of them (block sizes 3 and 4 with
multicolour Gauss–Seidel) would compile one XLA program of several thousand
operations (8 and 4 colours, 28 and 81 terms a product); they run the JAX
package's own host outer loop (``outer_loop="host"``) with its cycle called
as Python and every SpMV a jitted call of ``openmg_tpu.ops.sparse.spmv`` —
the Pallas BSR kernel in interpret mode where it applies — which is the
same arithmetic at a small fraction of the compile time.
"""

import functools

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.core import algebraic as jalg
from openmg_tpu.ops import sparse as jsparse
from openmg_tpu_torch.core import algebraic as talg
from openmg_tpu_torch.ops import sparse as tsparse
from openmg_tpu_torch.utils.convert import sparse_hierarchy_from_numpy

from _torch_parity import (
    non_stencil_spd, rand, sparse_spec_from_jax_hierarchy, to_j, to_n, to_t,
)
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)


def _rhs(n, seed):
    b = np.random.default_rng(seed).standard_normal(n)
    return b / np.linalg.norm(b)


# name -> (matrix builder, grid shape, dofs, config keywords)
SOLVES = {
    "ell-rbgs": (lambda: jmg.poisson((32, 32)), (32, 32), 1, dict(
        format="ell", smoother="rbgs", transfer="linear",
        max_dense_coarse=64)),
    "elasticity-bsr2-jacobi": (lambda: jmg.elasticity((16, 16)), (16, 16), 2,
                               dict(format="bsr", blocksize=2,
                                    smoother="jacobi", transfer="linear",
                                    gridlevels=3, max_dense_coarse=4096)),
    "coupled-bsr4-rbgs": (lambda: jmg.coupled_diffusion((8, 8, 8), 4),
                          (8, 8, 8), 4, dict(
                              format="bsr", blocksize=4, smoother="rbgs",
                              transfer="linear", gridlevels=2,
                              max_dense_coarse=4096)),
    "elasticity3d-bsr3-rbgs": (lambda: jmg.elasticity((8, 8, 8)), (8, 8, 8), 3,
                               dict(format="bsr", blocksize=3,
                                    smoother="rbgs", transfer="linear",
                                    gridlevels=2, max_dense_coarse=4096)),
}
# the cases whose reference runs the host loop with jitted SpMVs (see the
# module docstring)
EAGER_CYCLE = ("coupled-bsr4-rbgs", "elasticity3d-bsr3-rbgs")


def _config(pkg, kw):
    return pkg.SolverConfig(threshold=1e-10, cycles=200, **kw)


def _reference_solve(name, A, b, shape, dofs, kw):
    if name not in EAGER_CYCLE:
        solver = jmg.setup_sparse(A, shape, _config(jmg, kw), dofs=dofs)
        return solver.solve(b)
    cfg = _config(jmg, {**kw, "outer_loop": "host"})
    solver = jmg.setup_sparse(A, shape, cfg, dofs=dofs)
    solver._cycle = functools.partial(
        jalg._sparse_cycle_impl, pre=cfg.pre_iterations,
        post=cfg.post_iterations, smoother=cfg.smoother,
        cycle_type=cfg.cycle_type, omega=cfg.omega,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jalg, "spmv", jax.jit(jsparse.spmv))
        x, info = solver.solve(b)
    assert info["outer_loop"] == "host"
    return x, info


@pytest.fixture(scope="module", params=list(SOLVES))
def solved(request):
    """One case solved by both packages: (x_ref, info_ref, x_port,
    info_port)."""
    build, shape, dofs, kw = SOLVES[request.param]
    A = build()
    b = _rhs(A.shape[0], 3)
    xr, ir = _reference_solve(request.param, A, b, shape, dofs, kw)
    ts = tmg.setup_sparse(A, shape, _config(tmg, kw), dofs=dofs, device="cpu")
    xp, ip = ts.solve(b)
    return np.asarray(xr), ir, xp, ip


def test_solve_matches_reference(solved):
    xr, ir, xp, ip = solved
    assert ir["converged"] and ip["converged"]
    assert ip["cycles"] == ir["cycles"], (ip["residual_norms"], ir["residual_norms"])
    assert ip["num_colors"] == ir["num_colors"]
    assert ip["level_stats"] == tuple(ir["level_stats"])
    assert ip["format"] == ir["format"] and ip["residual_mode"] == "doublefloat"
    assert isinstance(xp, np.ndarray) and xp.dtype == np.float64
    assert np.max(np.abs(xp - xr)) <= 1e-9


def test_solve_history_matches_reference(solved):
    """Residual norms cycle by cycle: equal to 1e-4 relative above 1e-8,
    within 1.5x near the double-float floor."""
    _, ir, _, ip = solved
    a, b = np.asarray(ip["residual_norms"]), np.asarray(ir["residual_norms"])
    big = b > 1e-8
    np.testing.assert_allclose(a[big], b[big], rtol=1e-4)
    assert np.all(a[~big] <= 1.5 * b[~big]) and np.all(b[~big] <= 1.5 * a[~big])


# colourings and hierarchies ------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8), (6, 4, 8), (7, 5)])
def test_parity_colors_equal(shape):
    A = jmg.poisson(shape)
    a = jalg.parity_colors(A, shape)
    b = talg.parity_colors(A, shape)
    assert a is not None and np.array_equal(a, b)
    # a 9-point coupling has no parity colouring in either package
    A9 = sp.csr_matrix(A + sp.eye(A.shape[0], k=shape[-1] + 1))
    assert jalg.parity_colors(A9, shape) is None
    assert talg.parity_colors(A9, shape) is None


@pytest.mark.parametrize("which", ["nonstencil", "coupled"])
def test_greedy_colors_equal(which):
    A = (non_stencil_spd((8, 8)) if which == "nonstencil"
         else jmg.coupled_diffusion((4, 4, 4), 4))
    a = jalg.greedy_colors(A)
    assert np.array_equal(a, talg.greedy_colors(A))
    coo = sp.coo_matrix(A)
    off = coo.row != coo.col
    assert np.all(a[coo.row[off]] != a[coo.col[off]])


# name -> (matrix builder, grid shape, build keywords)
HIERARCHIES = {
    "ell-rbgs-linear": (lambda: jmg.poisson((16, 16)), (16, 16), dict(
        fmt="ell", smoother="rbgs", transfer_name="linear",
        max_dense_coarse=16)),
    "bsr-coupled-dofs4": (lambda: jmg.coupled_diffusion((4, 4, 4), 4),
                          (4, 4, 4), dict(fmt="bsr", blocksize=4, dofs=4,
                                          smoother="rbgs",
                                          transfer_name="linear",
                                          max_dense_coarse=32)),
    "csr-nonstencil-aggregate": (lambda: non_stencil_spd((8, 8)), (8, 8), dict(
        fmt="csr", smoother="rbgs", transfer_name="aggregate",
        max_dense_coarse=16)),
    "dense-float64-residual": (lambda: jmg.poisson((8, 8)), (8, 8), dict(
        fmt="dense", smoother="jacobi", residual_dtype="float64",
        max_dense_coarse=16)),
}


def _spec_equal(a, b, path="spec"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _spec_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _spec_equal(u, v, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def _port_spec(h):
    """The port's hierarchy in the layout of the parity helper's spec."""
    def cont(M):
        if M is None:
            return None
        d = {f: getattr(M, f) for f in M.__dataclass_fields__}
        d = {k: to_n(v) if isinstance(v, torch.Tensor) else v for k, v in d.items()}
        d["format"] = {tsparse.ELLMatrix: "ell", tsparse.CSRMatrix: "csr",
                       tsparse.BSRMatrix: "bsr", tsparse.DenseMatrix: "dense"}[type(M)]
        return d

    levels = [
        {"A": cont(L.A), "inv_diag": to_n(L.inv_diag), "R": cont(L.R),
         "P": cont(L.P),
         "colors": None if L.colors is None else to_n(L.colors),
         "num_colors": L.num_colors, "lam_max": float(L.lam_max)}
        for L in h.levels
    ]
    return {
        "fmt": h.fmt, "shapes": h.shapes, "transfer_name": h.transfer_name,
        "dofs": h.dofs, "stats": h.stats, "levels": levels,
        "coarse_inv": to_n(h.coarse_inv), "fine_hi": cont(h.fine_hi),
        "fine_lo": cont(h.fine_lo),
    }


@pytest.mark.parametrize("name", list(HIERARCHIES))
def test_hierarchy_arrays_bit_equal(name):
    build, shape, kw = HIERARCHIES[name]
    A = build()
    jh = jalg.build_sparse_hierarchy(A, shape, **kw)
    th = talg.build_sparse_hierarchy(A, shape, device="cpu", **kw)
    ref = sparse_spec_from_jax_hierarchy(jh)
    _spec_equal(_port_spec(th), ref)
    # and the carried-over hierarchy is the port's own, array for array
    _spec_equal(_port_spec(sparse_hierarchy_from_numpy(ref, "cpu")), ref)


# one cycle on a carried-over hierarchy --------------------------------------


@pytest.mark.parametrize("smoother,gamma", [
    ("rbgs", 1), ("jacobi", 1), ("rbgs", 2), ("chebyshev", 1),
])
def test_v_cycle_on_carried_hierarchy(smoother, gamma):
    A = jmg.poisson((16, 16))
    jh = jalg.build_sparse_hierarchy(
        A, (16, 16), fmt="ell", smoother="rbgs", transfer_name="linear",
        max_dense_coarse=16,
    )
    th = sparse_hierarchy_from_numpy(sparse_spec_from_jax_hierarchy(jh), "cpu")
    b = rand(A.shape[0], 11)
    cycle = jax.jit(jalg.sparse_v_cycle,
                    static_argnames=("smoother", "gamma"))
    ref = cycle(jh, to_j(b), to_j(np.zeros_like(b)), smoother=smoother,
                gamma=gamma)
    got = talg.sparse_v_cycle(th, to_t(b), torch.zeros(A.shape[0]),
                              smoother=smoother, gamma=gamma)
    tol = 2e-6 * float(np.max(np.abs(np.asarray(ref))))
    assert float(np.max(np.abs(to_n(got) - np.asarray(ref)))) <= tol


def test_v_cycle_bsr_with_block_transfers():
    """dofs > 1: the transfers are ELL SpMVs with R ⊗ I (the gather path),
    the level products the blocked-band BSR plain version."""
    A = jmg.elasticity((8, 8))
    jh = jalg.build_sparse_hierarchy(
        A, (8, 8), fmt="bsr", blocksize=2, dofs=2, smoother="jacobi",
        transfer_name="linear", max_dense_coarse=32,
    )
    th = sparse_hierarchy_from_numpy(sparse_spec_from_jax_hierarchy(jh), "cpu")
    assert th.geom_transfer(0) is None and th.levels[0].A.slot_offsets is not None
    b = rand(A.shape[0], 12)
    ref = jalg.sparse_v_cycle(jh, to_j(b), to_j(np.zeros_like(b)))
    got = talg.sparse_v_cycle(th, to_t(b), torch.zeros(A.shape[0]))
    tol = 2e-6 * float(np.max(np.abs(np.asarray(ref))))
    assert float(np.max(np.abs(to_n(got) - np.asarray(ref)))) <= tol


# mg_solve, the device-native rhs, the residual modes -------------------------


def test_mg_solve_falls_back_to_the_sparse_engine():
    shape = (16, 16)
    A = non_stencil_spd(shape, seed=4)
    b = tmg.rhs_random(shape, seed=5).ravel()
    params = {"problemshape": shape, "threshold": 1e-10, "cycles": 300,
              "max_dense_coarse": 64}
    xr, ir = jmg.mg_solve(A, b, params)
    xp, ip = tmg.mg_solve(A, b, params, device="cpu")
    assert ip["format"] == ir["format"] == "ell"
    assert ip["cycles"] == ir["cycles"] and ip["converged"]
    assert ip["num_colors"] == ir["num_colors"]
    assert np.max(np.abs(xp - np.asarray(xr))) <= 1e-9
    x_direct = spla.spsolve(sp.csc_matrix(A), b)
    assert np.linalg.norm(xp - x_direct) / np.linalg.norm(x_direct) < 1e-8


@pytest.mark.parametrize("fmt", ["ell", "csr", "bsr", "dense"])
def test_mg_solve_with_a_sparse_format(fmt):
    shape = (16, 16)
    b = tmg.rhs_random(shape, seed=3).ravel()
    x, info = tmg.mg_solve(None, b, {
        "problemshape": shape, "format": fmt, "smoother": "rbgs",
        "threshold": 1e-10, "cycles": 200, "max_dense_coarse": 16,
    }, device="cpu")
    assert info["format"] == fmt and info["converged"]
    assert info["gridlevels"] == 3 and info["num_colors"] == (2, 2, 2)
    x_direct = spla.spsolve(sp.csc_matrix(tmg.poisson(shape)), b)
    assert np.max(np.abs(x - x_direct)) <= 1e-9


def test_stencil_matrix_stays_on_the_stencil_engine():
    shape = (16, 16)
    b = tmg.rhs_random(shape, seed=3).ravel()
    _, info = tmg.mg_solve(tmg.poisson(shape), b, {
        "problemshape": shape, "max_dense_coarse": 16}, device="cpu")
    assert "format" not in info and info["converged"]


def test_device_native_rhs():
    """A float32 tensor rhs stays a tensor: the hi part comes back, the pair
    is in info['x_df'], and it agrees with the float64 host path."""
    shape = (16, 16)
    cfg = tmg.SolverConfig(transfer="linear", format="ell", gridlevels=3,
                           max_dense_coarse=4096, cycles=60)
    solver = tmg.setup_sparse(tmg.poisson(shape), shape, cfg, device="cpu")
    bf = torch.from_numpy(_rhs(256, 4).astype(np.float32))
    x, info = solver.solve(bf)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
    assert info["converged"] and "x_df" in info
    full = to_n(info["x_df"][0]).astype(np.float64) + to_n(info["x_df"][1])
    x_host, _ = solver.solve(to_n(bf).astype(np.float64))
    assert np.max(np.abs(full - x_host)) <= 1e-10


@pytest.mark.parametrize("rdt", ["float64", "float32"])
def test_plain_residual_modes(rdt):
    shape = (16, 16)
    cfg = tmg.SolverConfig(transfer="linear", format="ell", gridlevels=3,
                           max_dense_coarse=4096, cycles=60,
                           threshold=1e-10 if rdt == "float64" else 1e-5,
                           residual_dtype=rdt)
    solver = tmg.setup_sparse(tmg.poisson(shape), shape, cfg, device="cpu")
    b = _rhs(256, 6)
    x, info = solver.solve(b)
    assert info["converged"] and info["residual_mode"] == rdt
    assert solver.hierarchy.fine_lo is None
    assert solver.hierarchy.fine_hi.dtype == getattr(torch, rdt)
    r = np.linalg.norm(b - tmg.poisson(shape) @ x)
    assert r < (1.05e-10 if rdt == "float64" else 1e-5)


def test_general_and_stencil_engines_share_a_trajectory():
    """Jacobi with aggregate transfers is the same arithmetic on both
    engines: the first ten residual norms agree."""
    shape = (32, 32)
    b = tmg.rhs_random(shape, seed=8)
    cfg = tmg.SolverConfig(smoother="jacobi", transfer="aggregate",
                           threshold=1e-10, cycles=12)
    _, i_sten = tmg.setup(shape, cfg, device="cpu").solve(b)
    _, i_gen = tmg.setup_sparse(tmg.poisson(shape), shape, cfg,
                                device="cpu").solve(b.ravel())
    np.testing.assert_allclose(i_gen["residual_norms"][:10],
                               i_sten["residual_norms"][:10], rtol=1e-4)


def test_sparse_engine_refuses_what_waits():
    """PCG, FMG and ``solve_many``, refused before they were ported, run;
    the dense format's size limit still refuses."""
    shape = (8, 8)
    A = tmg.poisson(shape)
    b = _rhs(64, 9)
    kw0 = dict(transfer="linear", gridlevels=2, max_dense_coarse=16)
    for kw in (dict(krylov="pcg"), dict(cycle_type="f")):
        x, info = tmg.setup_sparse(A, shape, tmg.SolverConfig(**kw0, **kw),
                                   device="cpu").solve(b)
        assert info["converged"] and np.linalg.norm(b - A @ x) < 1e-10 * 1.05
    solver = tmg.setup_sparse(A, shape, tmg.SolverConfig(**kw0), device="cpu")
    xs, info = solver.solve_many([b])
    x1, i1 = solver.solve(b)
    np.testing.assert_array_equal(xs[0], x1)
    assert info["cycles"] == [i1["cycles"]]
    with pytest.raises(ValueError, match="debug mode"):
        tmg.setup_sparse(tmg.poisson((32, 32, 32)), (32, 32, 32),
                         tmg.SolverConfig(format="dense", max_dense_coarse=512),
                         device="cpu")
