"""Sparse SPD matrices with no grid stencil, for the general sparse engine
and its distributed form: the pentadiagonal matrix (banded: every level
keeps slot offsets) and that matrix with scattered long-range couplings
(irregular: no slot offsets, so every partitioned level takes the
gathered-x tier).  The JAX package builds the same matrices in its tests
(``tests/test_parallel_sparse.py``: ``pentadiag``, ``_irregular_spd`` with 5
couplings; its record ``SPARSEDIST_r05.json`` took 8).

Host-side numpy/scipy only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["pentadiag", "irregular_spd", "unit_rhs"]


def pentadiag(n: int) -> sp.csr_matrix:
    """The symmetric diagonally dominant pentadiagonal SPD matrix of ``n``
    rows (offsets ±1, ±2)."""
    return sp.diags([-1.0, -2.0, 6.5, -2.0, -1.0], offsets=[-2, -1, 0, 1, 2],
                    shape=(n, n), format="csr")


def irregular_spd(n: int, seed: int = 0, couplings: int = 5) -> sp.csr_matrix:
    """:func:`pentadiag` plus ``couplings`` symmetric entries −0.01 at
    positions drawn from ``default_rng(seed)``, plus the identity."""
    rng = np.random.default_rng(seed)
    A = pentadiag(n).tolil()
    for _ in range(couplings):
        i, j = rng.integers(0, n, size=2)
        A[i, j] = A[j, i] = -0.01
    return sp.csr_matrix(A + sp.eye(n))


def unit_rhs(n: int, seed: int) -> np.ndarray:
    """A standard normal float64 vector of ``default_rng(seed)``, scaled to
    ‖b‖₂ = 1."""
    b = np.random.default_rng(seed).standard_normal(n)
    return b / np.linalg.norm(b)
