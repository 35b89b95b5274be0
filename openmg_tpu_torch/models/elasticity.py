"""Vector-PDE problem generators (twin of ``openmg_tpu/models/elasticity.py``):
dense-block operators for the BSR format of the general sparse engine.

* :func:`elasticity` — linear elasticity ``−μ∇²u − (λ+μ)∇(∇·u) = f`` on a
  regular 2D or 3D node grid, d dofs a node, central differences (the
  mixed-derivative terms couple the components through purely off-diagonal
  corner blocks).
* :func:`coupled_diffusion` — a B-species coupled reaction–diffusion system
  ``(L ⊗ M) + (I ⊗ C)`` with SPD diffusion-coupling ``M`` and reaction
  ``C``: every block is dense B×B and the matrix is SPD by construction.

Both return scipy CSR on the flat dof vector (node-major, dof-minor: dof
index = node·B + c).  Host scipy code, copied.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["elasticity", "coupled_diffusion"]


def _shift(shape, off):
    """Scalar node-shift matrix ``S[i, j] = 1`` iff node j is node i
    offset by ``off`` — Dirichlet: out-of-grid neighbors dropped."""
    S = None
    for n, d in zip(shape, off):
        E = sp.eye(int(n), int(n), k=int(d), format="csr")
        S = E if S is None else sp.kron(S, E, format="csr")
    return S


def elasticity(shape, lam: float = 1.0, mu: float = 1.0):
    """Linear elasticity on a 2D/3D node grid (d dofs per node).

    Discretizes ``−μ∇²u − (λ+μ)∇(∇·u) = f`` (Navier–Cauchy, homogeneous
    Dirichlet, unit mesh; plane strain in 2D) with central differences:
    3-point second derivatives and 4-corner cross stencils for the mixed
    ``∂bc`` terms.  The block stencil has ``d×d`` blocks on the
    (2d+1)-point star plus purely off-diagonal coupling blocks on the
    edge diagonals of every axis pair — dense-block structure no scalar
    format captures.

    Returns scipy CSR of shape ``(d·N, d·N)`` (node-major,
    component-minor).  Symmetric; positive-definite for lam, mu > 0.
    """
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    if d not in (2, 3):
        raise ValueError(f"elasticity supports 2D/3D node grids, got {shape}")
    if any(s < 3 for s in shape):
        raise ValueError(f"elasticity needs at least a 3x3 grid, got {shape}")
    lam = float(lam)
    mu = float(mu)
    if lam <= 0 or mu <= 0:
        raise ValueError(f"Lamé parameters must be positive: lam={lam} mu={mu}")
    lm = lam + mu

    stencil = {(0,) * d: (2 * d * mu + 2 * lm) * np.eye(d)}
    for b in range(d):
        for s in (1, -1):
            B = -mu * np.eye(d)
            B[b, b] = -(lam + 2 * mu)
            stencil[tuple(s if i == b else 0 for i in range(d))] = B
    for b in range(d):
        for c in range(b + 1, d):
            for sb in (1, -1):
                for sc in (1, -1):
                    B = np.zeros((d, d))
                    v = -lm / 4.0 * (sb * sc)
                    B[b, c] = v
                    B[c, b] = v
                    off = tuple(
                        sb if i == b else sc if i == c else 0
                        for i in range(d)
                    )
                    stencil[off] = B

    A = None
    for off, B in stencil.items():
        term = sp.kron(_shift(shape, off), sp.csr_matrix(B))
        A = term if A is None else A + term
    return A.tocsr()


def coupled_diffusion(shape, ndof: int = 4, *, coupling: float = 0.3,
                      reaction: float = 0.5, seed: int = 0):
    """B-species coupled reaction–diffusion operator ``(L ⊗ M) + (I ⊗ C)``
    on a 1D/2D/3D node grid.

    ``L`` is the scalar (2d+1)-point Dirichlet Laplacian on ``shape``
    (the same matrix :func:`openmg_tpu_torch.models.poisson.poisson` builds),
    ``M = I + coupling·(QᵀQ)/‖QᵀQ‖`` a dense SPD diffusion-coupling
    matrix (species diffuse into each other), and
    ``C = reaction·(I + QᵀQ/‖QᵀQ‖)`` a dense SPD linearized-reaction
    matrix.  Kronecker products of SPD factors ⇒ the operator is SPD with
    every node-pair block dense ``ndof×ndof``.  Returns scipy CSR of shape ``(B·n, B·n)``.
    """
    from openmg_tpu_torch.models.poisson import poisson

    B = int(ndof)
    if B < 2:
        raise ValueError(f"ndof must be >= 2 for a coupled system, got {B}")
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, B))
    G = Q.T @ Q
    G = G / np.linalg.norm(G, 2)
    M = np.eye(B) + float(coupling) * G
    C = float(reaction) * (np.eye(B) + G)
    L = sp.csr_matrix(poisson(tuple(int(s) for s in shape)))
    n = L.shape[0]
    A = sp.kron(L, sp.csr_matrix(M)) + sp.kron(
        sp.eye(n, format="csr"), sp.csr_matrix(C)
    )
    return A.tocsr()
