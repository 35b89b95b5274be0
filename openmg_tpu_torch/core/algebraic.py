"""General sparse-matrix multigrid (twin of ``openmg_tpu/core/algebraic.py``).

The stencil engine (:mod:`openmg_tpu_torch.core.hierarchy`) covers
grid-structured operators; this module covers the rest of the input domain
of ``mg_solve(A, b, parameters)``: an arbitrary sparse SPD matrix over the
grid named by ``problemshape``, with geometric transfers.

* explicit restriction/prolongation matrices per level (tap tensor
  products, :mod:`openmg_tpu_torch.utils.oracle`), ``⊗ I_dofs`` for a
  vector problem with ``dofs`` unknowns a node;
* Galerkin coarsening ``A[l+1] = R A P`` by scipy at setup (host, once);
* levels stored in the padded containers of
  :mod:`openmg_tpu_torch.ops.sparse` (ELL / CSR / BSR / dense);
* smoothing by weighted Jacobi, multicolour Gauss–Seidel (parity colours
  where the level is bipartite on its grid, else a greedy host colouring)
  or 4th-kind Chebyshev;
* a µ-cycle over the level list (V and W) and FMG, a dense direct coarse
  solve, and MG-preconditioned CG;
* the defect-correction outer loop of the stencil engine: a double-float
  residual with an f32 cycle reaches 1e-10 absolute residuals.

Multicolour GS uses ``x_i ← x_i + (b − A x)_i / a_ii`` one colour class at
a time: same-colour points never couple, so each update is the classical
GS update.  Every level SpMV goes through :func:`~openmg_tpu_torch.ops.
sparse.spmv`: on the card a banded ELL level launches K6 and a banded BSR
level K7, one launch a product.

The outer loop is the stencil engine's
(:func:`openmg_tpu_torch.core.solver.lockstep`): one inner solve, one
residual and one scalar read of ‖r‖ a step.  The inner solve is a V, W or
FMG cycle, or ``krylov_iters`` MG-preconditioned CG steps whose ``A p`` is
the fine level's SpMV.  ``solve_many`` runs a batch of right-hand sides in
lockstep, one host read of the batch's norms a step, as one ``(K, n)``
stack (the stencil engine's :class:`~openmg_tpu_torch.core.solver._Batch`):
every function of the cycle takes the stack, a banded level's SpMV is one
launch of K6b or K7b for it, the transfers and the smoothers' updates are
tensor code on it, and :func:`~openmg_tpu_torch.ops.sparse.spmv` runs the
other formats' products member by member (see its module).  The coarsest
level's product, the inner products of CG and the norms are taken member
by member by the scalar calls, so each member is bit-equal to its scalar
solve.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from openmg_tpu_torch.core.config import SolverConfig
from openmg_tpu_torch.core.solver import _Batch, _norm, _norms, _Step, lockstep
from openmg_tpu_torch.ops.doublefloat import df_add_f32, df_merge, df_split, df_sub
from openmg_tpu_torch.ops.sparse import (
    ELLMatrix,
    ell_from_scipy,
    from_scipy,
    matvec_full,
    spmv,
    spmv_df,
)
from openmg_tpu_torch.ops.transfer import TRANSFERS, prolong, restrict
from openmg_tpu_torch.utils.oracle import (
    max_gridlevels,
    weighted_prolongation,
    weighted_restriction,
)

__all__ = [
    "SparseLevel",
    "SparseHierarchy",
    "build_sparse_hierarchy",
    "sparse_v_cycle",
    "sparse_fmg_cycle",
    "AlgebraicSolver",
    "setup_sparse",
    "parity_colors",
    "greedy_colors",
]


# ---------------------------------------------------------------------------
# colouring (setup time, host)
# ---------------------------------------------------------------------------


def parity_colors(A, shape) -> np.ndarray | None:
    """Red-black colouring by grid-coordinate parity, or None if the matrix
    couples same-parity points (then red/black half-sweeps would not be
    true GS)."""
    import scipy.sparse as sp

    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if A.shape[0] != n:
        return None
    coo = sp.coo_matrix(A)
    par = np.zeros(n, dtype=np.int32)
    for idx in np.unravel_index(np.arange(n), shape):
        par ^= (idx & 1).astype(np.int32)
    off = coo.row != coo.col
    if np.any(par[coo.row[off]] == par[coo.col[off]]):
        return None
    return par


def greedy_colors(A) -> np.ndarray:
    """Greedy colouring of the (symmetrised) sparsity graph.

    A host Python loop over rows, O(nnz); used only at setup and only for
    levels where the parity colouring fails."""
    import scipy.sparse as sp

    S = sp.csr_matrix(A)
    S = (S + S.T).tocsr()
    n = S.shape[0]
    colors = np.full(n, -1, dtype=np.int32)
    indptr, indices = S.indptr, S.indices
    for i in range(n):
        neigh = indices[indptr[i]: indptr[i + 1]]
        used = set(int(c) for c in colors[neigh] if c >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


# ---------------------------------------------------------------------------
# hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseLevel:
    """One level of the sparse hierarchy.

    ``R``/``P`` map this level to and from the next coarser one (None at the
    coarsest); ``colors`` is the GS colouring (None when smoothing with
    Jacobi); ``lam_max`` is the setup-time Gershgorin bound on λmax(D⁻¹A)
    that the Chebyshev smoother uses.
    """

    A: object  # ELLMatrix | CSRMatrix | BSRMatrix | DenseMatrix
    inv_diag: torch.Tensor  # (n,)
    R: object | None
    P: object | None
    colors: torch.Tensor | None  # (n,) int32
    num_colors: int
    lam_max: torch.Tensor | None = None  # 0-d

    @property
    def n(self) -> int:
        return self.A.shape[0]


@dataclasses.dataclass(frozen=True)
class SparseHierarchy:
    levels: tuple  # tuple[SparseLevel, ...], finest first
    coarse_inv: torch.Tensor  # (nc, nc)
    fine_hi: ELLMatrix  # outer-residual operator, hi part
    fine_lo: ELLMatrix | None  # lo part (doublefloat) or None
    stats: tuple  # per-level (n, k_or_kb, true_nnz)
    fmt: str
    # per-level grid shapes and the transfer the explicit R/P were built
    # from: a factor-2 scalar level pair applies its transfers as the
    # strided grid ops of ops/transfer.py instead of an SpMV.  None keeps
    # the SpMV path.
    shapes: tuple | None = None
    transfer_name: str | None = None
    # dofs a node (vector PDEs): transfers are node transfers ⊗ I_dofs,
    # which the grid ops do not cover, so dofs > 1 keeps the SpMV path
    dofs: int = 1

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def n(self) -> int:
        return self.levels[0].n

    @property
    def device(self):
        return self.coarse_inv.device

    def geom_transfer(self, level: int):
        """The ``(fine_shape, coarse_shape, Transfer)`` triple when level →
        level+1 can run the separable grid transfers (every axis either
        halves exactly or is a kept size-1 axis), else None."""
        if self.shapes is None or self.transfer_name is None or self.dofs != 1:
            return None
        if level >= len(self.shapes) - 1:
            return None
        fs, cs = self.shapes[level], self.shapes[level + 1]
        if not all(f == 2 * c or (f == c == 1) for f, c in zip(fs, cs)):
            return None
        return fs, cs, TRANSFERS[self.transfer_name]


def _resolve_blocksize(n: int, want: int) -> int:
    """Largest divisor of n that is <= want (BSR needs exact tiling)."""
    b = min(max(int(want), 1), n)
    while n % b:
        b -= 1
    return b


def build_sparse_hierarchy(
    A,
    shape,
    gridlevels=None,
    fmt: str = "ell",
    transfer_name: str = "aggregate",
    dtype=np.float32,
    residual_dtype: str = "doublefloat",
    max_dense_coarse: int = 512,
    blocksize: int = 4,
    smoother: str = "jacobi",
    dofs: int = 1,
    device=None,
) -> SparseHierarchy:
    """Host-side setup: explicit R/P chain, scipy Galerkin products,
    conversion to the padded containers on ``device`` (CUDA when None; the
    package's device rule).

    ``dofs`` > 1 treats ``shape`` as the NODE grid of a vector PDE with that
    many unknowns a node (node-major, dof-minor): transfers become
    ``R_node ⊗ I_dofs``, which keeps the Galerkin operators block-structured
    with the same block size (the natural pairing with ``fmt='bsr'``)."""
    import scipy.sparse as sp

    from openmg_tpu_torch.core.hierarchy import _UNCOARSENABLE_DENSE_CAP
    from openmg_tpu_torch.core.solver import _resolve_device

    device = _resolve_device(device)
    shape = tuple(int(s) for s in shape)
    dofs = int(dofs)
    if dofs < 1:
        raise ValueError(f"dofs must be >= 1, got {dofs}")
    n = dofs * int(np.prod(shape))
    A = sp.csr_matrix(A).astype(np.float64)
    if A.shape != (n, n):
        raise ValueError(
            f"matrix shape {A.shape} != grid {shape} × {dofs} dofs ({n} rows)"
        )
    transfer = TRANSFERS[transfer_name]
    dtype = np.dtype(dtype)

    if gridlevels is None:
        gridlevels = 1
        s, cnt = list(shape), n
        while cnt > max_dense_coarse and gridlevels < max_gridlevels(shape):
            s = [max(1, v // 2) for v in s]
            cnt = dofs * int(np.prod(s))
            gridlevels += 1
    gridlevels = min(int(gridlevels), max_gridlevels(shape))

    # explicit transfer matrices and the Galerkin chain (host scipy)
    shapes = [shape]
    As, Rs, Ps = [A], [], []
    for _ in range(gridlevels - 1):
        s = shapes[-1]
        R = weighted_restriction(s, transfer.r_taps)
        P = weighted_prolongation(s, transfer.p_taps)
        if dofs > 1:
            eye = sp.eye(dofs, format="csr")
            R = sp.kron(R, eye, format="csr")
            P = sp.kron(P, eye, format="csr")
        Rs.append(R)
        Ps.append(P)
        As.append((R @ As[-1] @ P).tocsr())
        shapes.append(tuple(max(1, v // 2) for v in s))

    nc = As[-1].shape[0]
    if nc > max_dense_coarse:
        # an uncoarsenable grid degrades to the plain dense solve (up to a
        # hard cap) instead of erroring, as the stencil hierarchy does
        if gridlevels == 1 and nc <= _UNCOARSENABLE_DENSE_CAP:
            import warnings

            warnings.warn(
                f"grid cannot be coarsened; solving its {nc} unknowns "
                f"directly (above max_dense_coarse={max_dense_coarse})",
                stacklevel=2,
            )
        else:
            raise ValueError(
                f"coarsest level has {nc} unknowns > max_dense_coarse="
                f"{max_dense_coarse}; increase gridlevels"
            )
    coarse_inv = np.linalg.inv(As[-1].toarray())

    def put(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=dt))).to(device)

    levels, stats = [], []
    for lvl in range(gridlevels):
        Al = As[lvl]
        diag = Al.diagonal()
        if np.any(diag == 0):
            raise ValueError(f"level {lvl} operator has zero diagonal entries")
        if fmt == "bsr":
            bs = _resolve_blocksize(Al.shape[0], blocksize)
            Adev = from_scipy(Al, "bsr", dtype=dtype, device=device,
                              blocksize=(bs, bs))
        elif fmt == "dense":
            if Al.shape[0] > 16384:
                raise ValueError(
                    f"format='dense' is a debug mode; level 0 has "
                    f"{Al.shape[0]} rows (> 16384) — use a sparse format"
                )
            Adev = from_scipy(Al, "dense", dtype=dtype, device=device)
        else:
            Adev = from_scipy(Al, fmt, dtype=dtype, device=device)
        colors_np = None
        if smoother == "rbgs":
            colors_np = parity_colors(Al, shapes[lvl]) if dofs == 1 else None
            if colors_np is None:
                colors_np = greedy_colors(Al)
        # R/P are stored in ELL whatever the cycle's format (rectangular,
        # few taps a row)
        last = lvl == gridlevels - 1
        R = None if last else ell_from_scipy(Rs[lvl], dtype=dtype, device=device)
        P = None if last else ell_from_scipy(Ps[lvl], dtype=dtype, device=device)
        abs_off = np.asarray(np.abs(Al).sum(axis=1)).ravel() - np.abs(diag)
        lam_max = 1.0 + float(np.max(abs_off / np.abs(diag)))
        levels.append(
            SparseLevel(
                A=Adev,
                inv_diag=put(1.0 / diag),
                R=R,
                P=P,
                colors=None if colors_np is None else put(colors_np, np.int32),
                num_colors=0 if colors_np is None else int(colors_np.max()) + 1,
                lam_max=put(lam_max),
            )
        )
        k_stat = Adev.kb if fmt == "bsr" else Adev.k if fmt == "ell" else 0
        stats.append((int(Al.shape[0]), int(k_stat), int(Al.nnz)))

    # outer-residual operator: exact two-f32 split of the float64 fine matrix
    fine_ell64 = ell_from_scipy(A, dtype=np.float64, device="cpu")
    d64 = fine_ell64.data.numpy()
    hi = d64.astype(np.float32)
    cols = fine_ell64.cols.to(device)
    fine64 = dataclasses.replace(fine_ell64, cols=cols)
    if residual_dtype == "doublefloat":
        lo = (d64 - hi.astype(np.float64)).astype(np.float32)
        fine_hi = dataclasses.replace(fine64, data=put(hi, np.float32))
        fine_lo = dataclasses.replace(fine64, data=put(lo, np.float32))
    else:
        rd = np.dtype(residual_dtype)
        fine_hi = dataclasses.replace(fine64, data=put(d64, rd))
        fine_lo = None
    return SparseHierarchy(
        levels=tuple(levels),
        coarse_inv=put(coarse_inv),
        fine_hi=fine_hi,
        fine_lo=fine_lo,
        stats=tuple(stats),
        fmt=fmt,
        shapes=tuple(tuple(int(v) for v in s) for s in shapes),
        transfer_name=transfer_name,
        dofs=dofs,
    )


# ---------------------------------------------------------------------------
# cycle
# ---------------------------------------------------------------------------


def _smooth_sparse(level: SparseLevel, b, x, iterations: int, smoother, omega):
    if iterations <= 0:
        return x
    if smoother == "chebyshev":
        # 4th-kind Chebyshev with the setup-time Gershgorin bound λmax
        lam = level.lam_max
        r = b - spmv(level.A, x)
        d = (4.0 / 3.0) / lam * level.inv_diag * r
        for k in range(1, iterations + 1):
            x = x + d
            if k == iterations:
                break
            r = r - spmv(level.A, d)
            d = ((2 * k - 1) / (2 * k + 3)) * d + (
                (8 * k + 4) / (2 * k + 3)
            ) / lam * level.inv_diag * r
        return x
    if smoother == "jacobi" or level.colors is None:
        # a Python omega is rounded to the tensors' type, as the reference's
        # omega array is
        for _ in range(iterations):
            x = x + omega * level.inv_diag * (b - spmv(level.A, x))
        return x
    if smoother == "rbgs":
        for _ in range(iterations):
            for c in range(level.num_colors):
                upd = x + level.inv_diag * (b - spmv(level.A, x))
                x = torch.where(level.colors == c, upd, x)
        return x
    raise ValueError(f"unknown smoother {smoother!r}")


def _restrict_level(hierarchy: SparseHierarchy, level: int, r):
    """``R r`` at ``level``: the separable grid ops on a factor-2 scalar level
    pair, the SpMV with the explicit ELL matrix otherwise (the same values:
    the matrices are built from the same taps).  ``r`` may be a batch
    ``(K, n)``."""
    geom = hierarchy.geom_transfer(level)
    if geom is not None:
        fs, cs, transfer = geom
        lead = tuple(r.shape[:-1])
        return restrict(r.reshape(lead + fs), transfer, len(fs)).reshape(lead + (-1,))
    return spmv(hierarchy.levels[level].R, r)


def _prolong_level(hierarchy: SparseHierarchy, level: int, ec):
    """``P e`` at ``level`` (coarse level+1 → fine level); see
    :func:`_restrict_level`."""
    geom = hierarchy.geom_transfer(level)
    if geom is not None:
        fs, cs, transfer = geom
        lead = tuple(ec.shape[:-1])
        return prolong(ec.reshape(lead + cs), fs, transfer).reshape(lead + (-1,))
    return spmv(hierarchy.levels[level].P, ec)


def _coarse(hierarchy: SparseHierarchy, b):
    """The coarsest level's solve: one product with the dense inverse, one
    a member for a batch ``(K, n)`` (a product over the batch need not keep
    the bits of each column's)."""
    if b.ndim == 2:
        return torch.stack([_coarse(hierarchy, bm) for bm in b])
    return matvec_full(hierarchy.coarse_inv, b)


def sparse_v_cycle(
    hierarchy: SparseHierarchy,
    b,
    x,
    level: int = 0,
    pre: int = 2,
    post: int = 2,
    smoother: str = "jacobi",
    omega: float = 2.0 / 3.0,
    gamma: int = 1,
):
    """One µ-cycle on flat vectors, or a batch ``(K, n)`` of them
    (``gamma=1``: V, 2: W)."""
    L = hierarchy.levels[level]
    if level == hierarchy.num_levels - 1:
        return _coarse(hierarchy, b)
    x = _smooth_sparse(L, b, x, pre, smoother, omega)
    r = b - spmv(L.A, x)
    bc = _restrict_level(hierarchy, level, r)
    ec = torch.zeros_like(bc)
    visits = 1 if level == hierarchy.num_levels - 2 else gamma
    for _ in range(visits):
        ec = sparse_v_cycle(
            hierarchy, bc, ec, level + 1, pre, post, smoother, omega, gamma
        )
    x = x + _prolong_level(hierarchy, level, ec)
    return _smooth_sparse(L, b, x, post, smoother, omega)


def sparse_fmg_cycle(
    hierarchy: SparseHierarchy,
    b,
    pre: int = 2,
    post: int = 2,
    smoother: str = "jacobi",
    omega: float = 2.0 / 3.0,
):
    """Full-multigrid pass from a zero guess (cf.
    :func:`openmg_tpu_torch.core.cycle.fmg_cycle`): restrict ``b`` to every
    level, solve the coarsest exactly, then prolong upward with one V-cycle
    per level from that iterate."""
    bs = [b]
    for lvl in range(hierarchy.num_levels - 1):
        bs.append(_restrict_level(hierarchy, lvl, bs[-1]))
    x = _coarse(hierarchy, bs[-1])
    for lvl in range(hierarchy.num_levels - 2, -1, -1):
        x = _prolong_level(hierarchy, lvl, x)
        x = sparse_v_cycle(hierarchy, bs[lvl], x, lvl, pre, post, smoother, omega)
    return x


def _sparse_cycle(hierarchy, r, *, pre, post, smoother, cycle_type, omega):
    r32 = r.to(hierarchy.levels[0].inv_diag.dtype)
    if cycle_type == "f":
        return sparse_fmg_cycle(hierarchy, r32, pre, post, smoother, omega)
    gamma = {"v": 1, "w": 2}.get(cycle_type)
    if gamma is None:
        raise ValueError(f"unknown cycle_type {cycle_type!r}; choose v|w|f")
    return sparse_v_cycle(
        hierarchy, r32, torch.zeros_like(r32), 0, pre, post, smoother, omega,
        gamma,
    )


def _sparse_pcg(hierarchy, r0, *, iters, pre, post, smoother, cycle_type, omega):
    """``iters`` MG-preconditioned CG steps on ``A e = r0`` from zero (the
    general-sparse twin of :func:`openmg_tpu_torch.core.cycle.pcg_solve`):
    one SpMV of the fine level operator (K6 or K7 where it is banded) and
    one cycle a step; the inner products stay 0-d tensors on the device
    (``(K, 1)`` on a batch ``(K, n)``, each member's by the scalar call on
    its rows)."""
    A0 = hierarchy.levels[0].A
    r32 = r0.to(hierarchy.levels[0].inv_diag.dtype)

    def precond(rr):
        return _sparse_cycle(
            hierarchy, rr, pre=pre, post=post, smoother=smoother,
            cycle_type=cycle_type, omega=omega,
        )

    def dot(u, v):
        if u.ndim == 1:
            return torch.sum(u * v)
        return torch.stack([torch.sum(w) for w in u * v]).reshape(-1, 1)

    e = torch.zeros_like(r32)
    r = r32
    z = precond(r)
    p = z
    rz = dot(r, z)
    for it in range(iters):
        Ap = spmv(A0, p)
        alpha = rz / dot(p, Ap)
        e = e + alpha * p
        if it == iters - 1:
            break
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        rz = rz_new
        p = z + beta * p
    return e


def _sparse_error(
    hierarchy, r, *, pre, post, smoother, cycle_type, omega, krylov="none",
    krylov_iters=2,
):
    """Inner error solve: one cycle, or MG-preconditioned CG."""
    if krylov == "pcg":
        return _sparse_pcg(
            hierarchy, r, iters=krylov_iters, pre=pre, post=post,
            smoother=smoother, cycle_type=cycle_type, omega=omega,
        )
    return _sparse_cycle(
        hierarchy, r, pre=pre, post=post, smoother=smoother,
        cycle_type=cycle_type, omega=omega,
    )


def _sparse_residual_df(fine_hi, fine_lo, b_df, x_df, norm=_norm):
    ax = spmv_df(fine_hi, fine_lo, x_df[0], x_df[1])
    r = df_sub(b_df, ax)
    return r, norm(r[0])


def _sparse_residual(fine_hi, b, x, norm=_norm):
    r = b - spmv(fine_hi, x)
    return r, norm(r)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


class AlgebraicSolver:
    """General sparse solver: the contract of
    :class:`openmg_tpu_torch.core.solver.Solver` (defect-correction outer
    loop, per-cycle residual history, ``solve_many``) on flat vectors."""

    def __init__(self, hierarchy: SparseHierarchy, config: SolverConfig):
        self.hierarchy = hierarchy
        self.config = config
        self.device = hierarchy.device
        self.df = hierarchy.fine_lo is not None

    @property
    def n(self) -> int:
        return self.hierarchy.n

    def _cycle(self, r):
        """The inner error solve of an outer step (one cycle, or
        ``krylov_iters`` CG steps with ``krylov="pcg"``)."""
        cfg = self.config
        return _sparse_error(
            self.hierarchy, r, pre=cfg.pre_iterations,
            post=cfg.post_iterations, smoother=cfg.smoother,
            cycle_type=cfg.cycle_type, omega=cfg.omega,
            krylov=cfg.krylov or "none", krylov_iters=cfg.krylov_iters,
        )

    def _step(self, b, x0):
        """The outer loop's state for ``A x = b`` from ``x0``, and whether
        ``b`` is device-native (a float32 tensor; double-float mode only)."""
        h = self.hierarchy
        b_dev, x, device_native = self._inputs(b, x0)
        if self.df:
            def resid(xx):
                r_pair, rn = _sparse_residual_df(h.fine_hi, h.fine_lo, b_dev, xx)
                return r_pair[0], rn

            return _Step(x, resid, df_add_f32, self._cycle), device_native
        step = _Step(
            x, lambda xx: _sparse_residual(h.fine_hi, b_dev, xx),
            lambda xx, e: xx + e.to(xx.dtype), self._cycle,
        )
        return step, device_native

    def _batch(self, members, x0s):
        """The outer loops of ``members`` from ``x0s`` as one ``(K, n)``
        :class:`~openmg_tpu_torch.core.solver._Batch`."""
        h = self.hierarchy
        ins = [self._inputs(b, x0) for b, x0 in zip(members, x0s)]
        if self.df:
            b = tuple(torch.stack([i[0][j] for i in ins]) for j in (0, 1))
            x = tuple(torch.stack([i[1][j] for i in ins]) for j in (0, 1))

            def resid(xx, bb):
                r_pair, rn = _sparse_residual_df(h.fine_hi, h.fine_lo, bb, xx, _norms)
                return r_pair[0], rn

            return _Batch.general(x, b, resid, df_add_f32, self._cycle)
        b = (torch.stack([i[0] for i in ins]),)
        x = (torch.stack([i[1] for i in ins]),)
        return _Batch.general(
            x, b, lambda xx, bb: _sparse_residual(h.fine_hi, bb[0], xx[0], _norms),
            lambda xx, e: (xx[0] + e.to(xx[0].dtype),), self._cycle,
        )

    def _inputs(self, b, x0):
        """``b`` and ``x0`` as the outer loop takes them on the solver's
        device (a double-float pair each, or the residual dtype's arrays; x
        zero without ``x0``), and whether ``b`` is device-native."""
        h = self.hierarchy
        dev = self.device
        device_native = (
            self.df and isinstance(b, torch.Tensor) and b.dtype == torch.float32
        )
        if device_native:
            if b.device != dev:
                raise ValueError(
                    f"b is on {b.device} but the solver was set up on {dev}"
                )
            b1 = b.reshape(-1).contiguous()
            b_dev = (b1, torch.zeros_like(b1))
            if x0 is None:
                x = (torch.zeros_like(b1), torch.zeros_like(b1))
            elif isinstance(x0, torch.Tensor) and x0.dtype == torch.float32:
                x = (x0.reshape(-1).to(dev).contiguous(), torch.zeros_like(b1))
            else:
                x = df_split(_host(x0).reshape(-1), dev)
        else:
            b_np = _host(b).reshape(-1)
            x0_np = np.zeros(self.n) if x0 is None else _host(x0).reshape(-1)
            if self.df:
                b_dev = df_split(b_np, dev)
                x = df_split(x0_np, dev)
            else:
                rd = h.fine_hi.dtype
                b_dev = torch.from_numpy(b_np).to(device=dev, dtype=rd)
                x = torch.from_numpy(x0_np).to(device=dev, dtype=rd)
        return b_dev, x, device_native

    def _info(self, solve_time):
        h = self.hierarchy
        return {
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "format": h.fmt,
            "residual_mode": (
                "doublefloat" if self.df
                else str(h.fine_hi.dtype).replace("torch.", "")
            ),
            "num_colors": tuple(lv.num_colors for lv in h.levels),
            "outer_loop": "host",
            "solve_time_s": solve_time,
        }

    def _say(self, i, k, rnorm, batch=False):
        if self.config.verbose:
            who = f" rhs {i}" if batch else ""
            print(f"[openmg_tpu_torch/sparse]{who} cycle {k}: ‖r‖ = {rnorm:.3e}")

    def solve(self, b, x0=None):
        """Solve ``A x = b`` to the configured threshold.

        A numpy (or any non-float32-tensor) ``b`` returns the float64 merge
        of the double-float pair as a flat numpy vector.  A float32 tensor
        ``b`` on the solver's device stays there: the float32 hi part is
        returned as a tensor and the full pair is in ``info['x_df']``.
        """
        cfg = self.config
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        t_start = time.perf_counter()
        step, device_native = self._step(b, x0)
        (history,), (converged,), (cycle_times,), _ = lockstep(
            [step], limit, float(cfg.threshold), self._say
        )
        x = step.x
        if device_native:
            x_out = x[0]
        elif self.df:
            x_out = df_merge(x)
        else:
            x_out = x.detach().cpu().numpy().astype(np.float64)
        info = {
            "residual_norms": history,
            "cycles": len(history) - 1,
            "converged": converged,
            "final_norm": history[-1],
            **self._info(time.perf_counter() - t_start),
            # enqueue times of the cycles (the loop synchronises only at
            # the scalar read of the next residual)
            "cycle_times_s": cycle_times,
            "mean_cycle_time_s": (
                float(np.mean(cycle_times[1:] or cycle_times))
                if cycle_times else float("nan")
            ),
        }
        if device_native:
            info["x_df"] = x
        return x_out, info

    def solve_many(self, bs, x0s=None):
        """A batch of right-hand sides in lockstep, as one ``(K, n)`` stack
        (the contract of
        :meth:`openmg_tpu_torch.core.solver.Solver.solve_many`: one host
        read of the batch's norms a step, a converged member frozen, each
        member bit-equal to its scalar :meth:`solve`).  Host/numpy input
        returns stacked float64 ``xs`` of shape ``(K, n)``; a ``(K, n)``
        float32 tensor on the solver's device (double-float mode) returns
        the float32 hi parts, the pairs in ``info['x_df']``."""
        cfg = self.config
        device_native = (
            self.df and isinstance(bs, torch.Tensor) and bs.dtype == torch.float32
        )
        if device_native:
            members = list(bs.reshape(bs.shape[0], -1))
        else:
            members = [_host(b).reshape(-1) for b in bs]
        K = len(members)
        if x0s is None:
            x0s = [None] * K
        elif len(x0s) != K:
            raise ValueError(f"{len(x0s)} initial guesses for {K} right-hand sides")
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        t_start = time.perf_counter()
        batch = self._batch(members, x0s)
        histories, converged, _, reads = lockstep(
            list(range(K)), limit, float(cfg.threshold),
            lambda i, k, v: self._say(i, k, v, batch=True),
            norms=batch.norms, advance=batch.advance,
        )
        info = {
            "batch": K,
            "cycles": [len(h) - 1 for h in histories],
            "converged": converged,
            "final_norm": [h[-1] for h in histories],
            "residual_norms": histories,
            **self._info(time.perf_counter() - t_start),
            "host_reads": reads,
        }
        xs = batch.iterates()
        if device_native:
            info["x_df"] = xs
            return xs[0], info
        if self.df:
            return df_merge(xs), info
        return xs[0].detach().cpu().numpy().astype(np.float64), info


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def setup_sparse(
    A, shape, config: SolverConfig | None = None, *, dofs: int = 1, device=None
) -> AlgebraicSolver:
    """Build an :class:`AlgebraicSolver` on ``device`` (CUDA when None) for
    an arbitrary sparse SPD ``A`` over the grid ``shape`` (the general
    engine behind ``mg_solve``).  ``dofs`` > 1 marks a vector PDE with that
    many unknowns a node (block transfers; pair with ``format='bsr'`` and
    ``blocksize=dofs``, see :mod:`openmg_tpu_torch.models.elasticity`)."""
    config = config or SolverConfig()
    fmt = config.format if config.format not in (None, "auto", "stencil") else "ell"
    rmode = (
        config.residual_dtype
        if config.residual_dtype not in (None, "auto")
        else "doublefloat"
    )
    hierarchy = build_sparse_hierarchy(
        A,
        shape,
        gridlevels=config.gridlevels,
        fmt=fmt,
        transfer_name=config.transfer,
        dtype=np.dtype(config.dtype),
        residual_dtype=rmode,
        max_dense_coarse=config.max_dense_coarse,
        blocksize=config.blocksize,
        smoother=config.smoother,
        dofs=dofs,
        device=device,
    )
    return AlgebraicSolver(hierarchy, config)
