"""The batched forms K6b and K7b (K vectors through one banded matrix in one
launch, the JAX package's ``spmv_ell`` and ``spmv_bsr`` under ``jax.vmap``)
and ``AlgebraicSolver.solve_many`` as one ``(K, n)`` stack, on the CPU.

Tolerances: K6b and K7b's batched plain versions against the vmapped
reference kernels in interpret mode, ``tests/test_torch_sparse.py``'s:
1e-6 (float64: 1e-14) · max_i Σ_j |A_ij x_j|, the size of the terms a row
sums (the reference forms its shifts and sums in its own order); against
the port's scalar plain versions bit for bit, member by member.  Each
reference kernel is traced once, at K = 2; in float64, which the reference
kernels do not take, the reference's own SpMV of that type is the
reference.

The ``solve_many`` cases take every format (banded ELL and BSR, CSR,
dense) with V, FMG and PCG(2) on two levels of Poisson (8, 8, 8), Jacobi
V(1,1), where the reference's compiles stay near a second: each takes the
reference ``solve_many``'s cycle counts, every member is bit-equal to the
port's scalar solve, and on the banded formats spies count one K6b or K7b
call for the stack where the scalar path makes one a member, and no scalar
call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import openmg_tpu as jmg
import openmg_tpu_torch as tmg
from openmg_tpu.models import elasticity as jelas
from openmg_tpu.models import poisson as jpoisson
from openmg_tpu.ops import bsr as jbsr
from openmg_tpu.ops import ell as jell
from openmg_tpu.ops import sparse as jsparse
from openmg_tpu_torch.models import elasticity as telas
from openmg_tpu_torch.models import poisson as tpoisson
from openmg_tpu_torch.ops import bsr as tbsr
from openmg_tpu_torch.ops import ell as tell
from openmg_tpu_torch.ops import sparse as tsparse

from _torch_parity import to_n
from _torch_parity import one_blas_thread  # noqa: F401  (autouse)

K = 2
TOL = {np.float32: 1e-6, np.float64: 1e-14}


def _vectors(n, dtype, k=K, seed=10):
    return np.stack([np.random.default_rng(seed + m).standard_normal(n)
                     for m in range(k)]).astype(dtype)


def _close(got, ref, A, X, factor):
    """|got − ref| ≤ factor · max_i Σ_j |A_ij x_j| for each member."""
    A = sp.csr_matrix(A)
    for k in range(X.shape[0]):
        scale = float(np.max(abs(A) @ np.abs(X[k].astype(np.float64))))
        err = float(np.max(np.abs(to_n(got[k]).astype(np.float64)
                                  - np.asarray(ref[k], dtype=np.float64))))
        assert err <= factor * scale, (k, err, factor * scale)


# ---------------------------------------------------------------------------
# K6b / K7b plain versions against the vmapped reference kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_k6b_plain_matches_vmapped_reference(dtype):
    """float32: the reference's Pallas kernel; float64, which that kernel
    does not take, the reference's own SpMV of the type (its array code)."""
    A = jpoisson.poisson((8, 8, 16))
    jM = jsparse.ell_from_scipy(A, dtype=dtype)
    tM = tsparse.ell_from_scipy(A, dtype=dtype, device="cpu")
    assert jell.supports(jM) == (dtype == np.float32) and tell.supports(tM)
    one = jell.spmv_ell if dtype == np.float32 else jsparse.spmv
    X = _vectors(A.shape[0], dtype)
    ref = jax.vmap(lambda xx: one(jM, xx))(jnp.asarray(X))
    got = tell.spmv_ell_batch(tM, torch.from_numpy(X))
    assert got.dtype == torch.from_numpy(X).dtype
    _close(got, ref, A, X, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_k7b_plain_matches_vmapped_reference(dtype):
    """As K6b: float64 against the reference's banded array code."""
    A = jelas.coupled_diffusion((8, 8, 8), 4)
    jM = jsparse.bsr_from_scipy(A, blocksize=(4, 4), dtype=dtype)
    tM = tsparse.bsr_from_scipy(A, blocksize=(4, 4), dtype=dtype, device="cpu")
    assert jbsr.supports(jM) == (dtype == np.float32) and tbsr.supports(tM)
    one = jbsr.spmv_bsr if dtype == np.float32 else jbsr.spmv_banded_jnp
    X = _vectors(A.shape[0], dtype)
    ref = jax.vmap(lambda xx: one(jM, xx))(jnp.asarray(X))
    got = tbsr.spmv_bsr_batch(tM, torch.from_numpy(X))
    _close(got, ref, A, X, TOL[dtype])


# ---------------------------------------------------------------------------
# K6b / K7b plain versions against the port's scalar plain versions
# ---------------------------------------------------------------------------

ELL_CASES = {
    "poisson3d": lambda: tpoisson.poisson((4, 6, 10)),
    "poisson2d": lambda: tpoisson.poisson((37, 11)),
}
BSR_CASES = {
    "coupled-B4": (lambda: telas.coupled_diffusion((4, 4, 6), 4), 4),
    "elasticity-B3": (lambda: telas.elasticity((5, 4, 3)), 3),
    "poisson-B8": (lambda: tpoisson.poisson((8, 8, 8)), 8),
    "poisson-B2": (lambda: tpoisson.poisson((6, 10)), 2),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(ELL_CASES))
def test_k6b_is_the_scalar_k6_per_member(case, dtype):
    M = tsparse.ell_from_scipy(ELL_CASES[case](), dtype=dtype, device="cpu")
    X = torch.from_numpy(_vectors(M.shape[0], dtype, 3))
    got = tell.spmv_ell_batch(M, X)
    for k in range(3):
        assert torch.equal(got[k], tell.spmv_ell(M, X[k])), k
    # the dispatch of the sparse layer takes K6b for a (K, n) batch
    assert torch.equal(tsparse.spmv(M, X), got)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(BSR_CASES))
def test_k7b_is_the_scalar_k7_per_member(case, dtype):
    """Each member in the scalar launch's lanes (``bsr.lane_group``, more
    than one lane at these sizes) and tree, bit for bit."""
    make, B = BSR_CASES[case]
    M = tsparse.bsr_from_scipy(make(), blocksize=(B, B), dtype=dtype, device="cpu")
    assert M.slot_offsets is not None
    X = torch.from_numpy(_vectors(M.shape[0], dtype, 3))
    got = tbsr.spmv_bsr_batch(M, X)
    for k in range(3):
        assert torch.equal(got[k], tbsr.spmv_bsr(M, X[k])), k
    assert torch.equal(tsparse.spmv(M, X), got)


def test_other_formats_go_member_by_member():
    """An irregular ELL, CSR, a general BSR and a dense matrix take the
    scalar product on each member of a batch; ``spmv_df`` runs on the stack,
    each member bit-equal to its scalar call."""
    A = tpoisson.poisson((6, 5, 4))
    R = sp.random(A.shape[0], A.shape[0], density=0.02, random_state=3,
                  format="csr") + A
    X = torch.from_numpy(_vectors(A.shape[0], np.float32, 3))
    for M in (tsparse.ell_from_scipy(R, device="cpu"),
              tsparse.csr_from_scipy(R, device="cpu"),
              tsparse.bsr_from_scipy(R, blocksize=(2, 2), device="cpu"),
              tsparse.dense_from_scipy(A, device="cpu")):
        got = tsparse.spmv(M, X)
        for k in range(3):
            assert torch.equal(got[k], tsparse.spmv(M, X[k])), type(M).__name__
    for mat in (A, R):
        hi = tsparse.ell_from_scipy(mat, device="cpu")
        lo = tsparse.ell_from_scipy(mat * 1e-9, device="cpu")
        Xl = X * 1e-8
        got = tsparse.spmv_df(hi, lo, X, Xl)
        for k in range(3):
            one = tsparse.spmv_df(hi, lo, X[k], Xl[k])
            assert torch.equal(got[0][k], one[0]) and torch.equal(got[1][k], one[1])


def test_batched_sparse_wrappers_count_nothing_on_the_cpu():
    before = (tell.LAUNCHES_K6_BATCH, tbsr.LAUNCHES_K7_BATCH)
    E = tsparse.ell_from_scipy(tpoisson.poisson((4, 4, 8)), device="cpu")
    Bm = tsparse.bsr_from_scipy(telas.coupled_diffusion((4, 4, 4), 4),
                                blocksize=(4, 4), device="cpu")
    tell.spmv_ell_batch(E, torch.zeros(K, E.shape[0]))
    tbsr.spmv_bsr_batch(Bm, torch.zeros(K, Bm.shape[0]))
    assert (tell.LAUNCHES_K6_BATCH, tbsr.LAUNCHES_K7_BATCH) == before


def test_batched_sparse_wrappers_refuse_before_launching(monkeypatch):
    """The launch's checks run before the kernel is built (so here, on CPU
    tensors): members of another length, another type, members that alias
    one another (a stride-0 batch), a vector where a batch belongs; on a
    tensor that is not on the CPU the wrappers never run a plain version."""
    E = tsparse.ell_from_scipy(tpoisson.poisson((4, 4, 8)), device="cpu")
    n = E.shape[0]
    X = torch.zeros(K, n)
    with pytest.raises(ValueError, match="for 127 rows"):
        tell.spmv_banded_cuda("k", E.data, E.slot_offsets, 1, torch.zeros(K, n - 1),
                              batch=True)
    with pytest.raises(ValueError, match=r"expected \(K, 128\)"):
        tell.spmv_banded_cuda("k", E.data, E.slot_offsets, 1, X[0], batch=True)
    with pytest.raises(ValueError, match="one type"):
        tell.spmv_banded_cuda("k", E.data, E.slot_offsets, 1, X.double(), batch=True)
    with pytest.raises(ValueError, match="contiguous"):
        tell.spmv_banded_cuda("k", E.data, E.slot_offsets, 1,
                              torch.zeros(n).expand(K, n), batch=True)
    with pytest.raises(ValueError, match="rows in blocks"):
        tell.spmv_banded_cuda("k", E.data, E.slot_offsets, 4, X, batch=True)
    with pytest.raises(ValueError, match=r"not \(K, n\)"):
        tell.spmv_ell_batch(E, X[0])
    Bm = tsparse.bsr_from_scipy(telas.coupled_diffusion((4, 4, 4), 4),
                                blocksize=(4, 4), device="cpu")
    with pytest.raises(ValueError, match=r"not \(K, n\)"):
        tbsr.spmv_bsr_batch(Bm, torch.zeros(Bm.shape[0]))
    called = []
    monkeypatch.setattr(tell, "spmv_banded_batch_plain", lambda *a: called.append(1))
    monkeypatch.setattr(tbsr, "spmv_banded_batch_plain", lambda *a: called.append(1))
    for M, fn in ((E, tell.spmv_ell_batch), (Bm, tbsr.spmv_bsr_batch)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(M, torch.empty(K, M.shape[0], device="meta"))
    assert not called


# ---------------------------------------------------------------------------
# AlgebraicSolver.solve_many
# ---------------------------------------------------------------------------

SHAPE = (8, 8, 8)
INNERS = {"v": dict(), "fmg": dict(cycle_type="f"),
          "pcg": dict(krylov="pcg", krylov_iters=2)}
# K6 or K7 launches of one outer step at level 0 (the only visited level):
# Jacobi V(1,1) is three products a cycle, PCG(2) two cycles and two A p
PRODUCTS = {"v": 3, "fmg": 3, "pcg": 8}


def _config(pkg, fmt, inner):
    return pkg.SolverConfig(format=fmt, smoother="jacobi", transfer="linear",
                            gridlevels=2, max_dense_coarse=4096, cycles=60,
                            pre_iterations=1, post_iterations=1, blocksize=4,
                            **INNERS[inner])


def _rhs(n):
    rhs = [np.random.default_rng(s).standard_normal(n) for s in (1, 2, 3)]
    rhs[1] = rhs[1] * 1e-3  # converges first: the stack narrows
    return rhs


def _spies(monkeypatch):
    calls = {}
    for mod, name in ((tell, "spmv_ell_batch"), (tbsr, "spmv_bsr_batch"),
                      (tell, "spmv_ell"), (tbsr, "spmv_bsr")):
        real = getattr(mod, name)
        calls[name] = 0

        def spy(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("inner", list(INNERS))
@pytest.mark.parametrize("fmt", ["ell", "bsr", "csr", "dense"])
def test_sparse_solve_many_runs_one_stack(fmt, inner, monkeypatch):
    """The reference's ``solve_many`` cycle counts, every member bit-equal
    to its scalar solve, one host read a step, and on the banded formats
    one batched SpMV call for the stack a product, no scalar one."""
    A = tpoisson.poisson(SHAPE)
    rhs = _rhs(A.shape[0])
    # the reference's BSR kernel costs seconds a trace in interpret mode: its
    # FMG and PCG counts are its CSR solve's of the same matrix (the format
    # changes the storage, not the iteration; its V counts agree)
    ref_fmt = "csr" if fmt == "bsr" and inner != "v" else fmt
    _, ir = jmg.setup_sparse(A, SHAPE, _config(jmg, ref_fmt, inner)).solve_many(rhs)
    solver = tmg.setup_sparse(A, SHAPE, _config(tmg, fmt, inner), device="cpu")
    scalar = [solver.solve(b) for b in rhs]
    calls = _spies(monkeypatch)
    xs, info = solver.solve_many(rhs)
    steps = max(info["cycles"])
    assert info["cycles"] == ir["cycles"]
    assert info["cycles"][1] < info["cycles"][0]
    assert info["host_reads"] == steps + 1
    for k, (xk, ik) in enumerate(scalar):
        np.testing.assert_array_equal(xs[k], xk)
        assert info["residual_norms"][k] == ik["residual_norms"]
    batched = {"ell": "spmv_ell_batch", "bsr": "spmv_bsr_batch"}.get(fmt)
    want = {name: 0 for name in calls}
    if batched:
        want[batched] = PRODUCTS[inner] * steps
    assert calls == want


def test_sparse_solve_many_initial_guesses_and_device_batch():
    """``x0s`` (some members without) and a float32 ``(K, n)`` tensor batch,
    on the coupled-diffusion BSR problem (B = 4, four unknowns a node:
    its transfers are explicit ELL matrices, taken member by member)."""
    A = telas.coupled_diffusion((4, 4, 8), 4)
    cfg = tmg.SolverConfig(format="bsr", blocksize=4, smoother="jacobi",
                           transfer="linear", gridlevels=2, max_dense_coarse=4096,
                           cycles=80)
    solver = tmg.setup_sparse(A, (4, 4, 8), cfg, dofs=4, device="cpu")
    rhs = _rhs(A.shape[0])
    bs = torch.from_numpy(np.stack(rhs).astype(np.float32))
    x0s = [None, rhs[1] * 0.1, None]
    xd, info = solver.solve_many(bs, x0s=x0s)
    assert isinstance(xd, torch.Tensor) and xd is info["x_df"][0]
    assert tuple(xd.shape) == (3, A.shape[0])
    for k in range(3):
        xk, ik = solver.solve(bs[k].clone(), x0=x0s[k])
        assert torch.equal(xd[k], xk) and torch.equal(info["x_df"][1][k], ik["x_df"][1])
        assert info["cycles"][k] == ik["cycles"] and info["converged"][k]
