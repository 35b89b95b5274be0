"""Host-side transfer matrices of the general sparse engine (twin of the
builders in ``openmg_tpu/utils/oracle.py``).

Explicit scipy matrices of the geometric transfers: the aggregation
restriction of the original algorithm and the separable tap restriction /
prolongation (tensor products of 1D tap operators).  The sparse engine
(:mod:`openmg_tpu_torch.core.algebraic`) builds its Galerkin chain
``R A P`` from them at setup.  Copied as scipy code; the numpy mirror of the
whole algorithm (``v_cycle_np``, ``reference_mg_solve``) is not ported yet
(ROADMAP queue 1, item 18).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "aggregate_restriction",
    "taps_matrix_1d",
    "weighted_restriction",
    "weighted_prolongation",
    "max_gridlevels",
]


def max_gridlevels(shape) -> int:
    """Deepest hierarchy reachable by factor-2 coarsening (all dims must be
    even to halve; a dim of 1 stays 1)."""
    shape = [int(s) for s in shape]
    levels = 1
    while all(s == 1 or s % 2 == 0 for s in shape) and any(s > 1 for s in shape):
        shape = [max(1, s // 2) for s in shape]
        levels += 1
    return levels


def aggregate_restriction(shape) -> sp.csr_matrix:
    """Geometric aggregation restriction R.

    ``R[c, f] = 1/2^d`` for each of the ``2^d`` fine children ``f`` of coarse
    point ``c`` (per-dim children ``2c`` and ``2c+1``; dims of size 1 are not
    coarsened).  Shape ``(prod(coarse), prod(fine))``.
    """
    shape = tuple(int(s) for s in shape)
    cshape = tuple(max(1, s // 2) for s in shape)
    if any(s > 1 and s % 2 for s in shape):
        raise ValueError(f"all dims > 1 must be even to coarsen, got {shape}")
    d_eff = sum(1 for s in shape if s > 1)
    w = 1.0 / (2**d_eff)
    cgrid = np.indices(cshape)  # (d, *cshape)
    rows_all, cols_all = [], []
    parities = np.indices(tuple(2 if s > 1 else 1 for s in shape))
    parities = parities.reshape(len(shape), -1).T  # (2^d_eff, d)
    crow = np.ravel_multi_index(
        tuple(cgrid[a] for a in range(len(shape))), cshape
    ).ravel()
    for p in parities:
        fine = tuple(
            (2 * cgrid[a] + p[a]) if shape[a] > 1 else cgrid[a]
            for a in range(len(shape))
        )
        fcol = np.ravel_multi_index(fine, shape).ravel()
        rows_all.append(crow)
        cols_all.append(fcol)
    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)
    vals = np.full(rows.shape, w)
    return sp.coo_matrix(
        (vals, (rows, cols)), shape=(int(np.prod(cshape)), int(np.prod(shape)))
    ).tocsr()


def taps_matrix_1d(n: int, taps) -> sp.csr_matrix:
    """1D tap operator: ``M[c, 2c + t] += w`` for each tap ``(t, w)``,
    shape ``(n/2, n)``, out-of-range taps dropped (zero-fill)."""
    m = n // 2
    rows, cols, vals = [], [], []
    for c in range(m):
        for t, w in taps:
            f = 2 * c + t
            if 0 <= f < n:
                rows.append(c)
                cols.append(f)
                vals.append(w)
    return sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()


def _kron_over_axes(shape, taps):
    M = None
    for s in shape:
        Ms = sp.identity(1, format="csr") if s == 1 else taps_matrix_1d(s, taps)
        M = Ms if M is None else sp.kron(M, Ms, format="csr")
    return M.tocsr()


def weighted_restriction(shape, r_taps) -> sp.csr_matrix:
    """Explicit separable restriction matrix (tensor product of 1D taps),
    the matrix form of :func:`openmg_tpu_torch.ops.transfer.restrict`."""
    return _kron_over_axes(tuple(int(s) for s in shape), r_taps)


def weighted_prolongation(shape, p_taps) -> sp.csr_matrix:
    """Explicit separable prolongation matrix: transpose structure of the
    taps (``P[2c+t, c] += w``), the matrix form of ``transfer.prolong``."""
    return _kron_over_axes(tuple(int(s) for s in shape), p_taps).T.tocsr()
