"""Poisson problem generators (twin of ``openmg_tpu/models/poisson.py``).

Host-side numpy/scipy only, copied: the d-dimensional negative Laplacian on
a regular grid with homogeneous Dirichlet boundaries, as a scipy CSR matrix
(``poisson``) and in stencil form (``poisson_stencil``: per-offset
coefficient grids, zero where the neighbour leaves the domain), plus the
reproducible right-hand sides.  ``rhs_random`` is bit-identical to the JAX
package's for the same seed (numpy's ``default_rng``).

Also the variable-coefficient diffusion operator (``diffusion_stencil``,
``diffusion``) and ``stencil_from_csr``, which extracts the exact stencil
form of a grid-structured sparse matrix.  ``stencil_to_csr`` serves the
oracles and the hierarchy's coarsest-level dense inverse.
``poisson_ell_device`` assembles the Poisson operator straight into the
sparse engine's slot-major ELL container with tensor code on a device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "poisson",
    "poisson_stencil",
    "poisson_offsets",
    "stencil_to_csr",
    "stencil_from_csr",
    "diffusion_stencil",
    "diffusion",
    "poisson_ell_device",
    "rhs_random",
    "rhs_ones",
]


def _lap1d(n: int) -> sp.csr_matrix:
    """1D tridiagonal (-1, 2, -1) operator (Dirichlet)."""
    return sp.diags(
        [-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
        offsets=[-1, 0, 1],
        format="csr",
    )


def poisson(shape) -> sp.csr_matrix:
    """d-dim Poisson matrix on a regular grid, row-major (C) ordering.

    Kron-sum of 1D Laplacians: diagonal ``2*d``, ``-1`` per face neighbour.
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0 or any(s < 1 for s in shape):
        raise ValueError(f"invalid problem shape {shape}")
    eyes = [sp.identity(s, format="csr") for s in shape]
    n = int(np.prod(shape))
    A = sp.csr_matrix((n, n))
    for axis in range(len(shape)):
        term = None
        for ax in range(len(shape)):
            M = _lap1d(shape[ax]) if ax == axis else eyes[ax]
            term = M if term is None else sp.kron(term, M, format="csr")
        A = A + term
    A = A.tocsr()
    A.sum_duplicates()
    return A


def poisson_offsets(ndim: int) -> tuple:
    """Stencil offsets of the (2d+1)-point Poisson operator: centre first,
    then -/+ unit offsets per axis."""
    offs = [(0,) * ndim]
    for axis in range(ndim):
        for s in (-1, 1):
            o = [0] * ndim
            o[axis] = s
            offs.append(tuple(o))
    return tuple(offs)


def poisson_stencil(shape, dtype=np.float64):
    """Analytic stencil form of :func:`poisson`.

    Returns ``(offsets, coeffs)`` with ``coeffs`` of shape ``(K, *shape)``:
    ``coeffs[k][i] == A[i, i + offsets[k]]`` and 0 where ``i + offsets[k]``
    is outside the grid.
    """
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    offsets = poisson_offsets(d)
    coeffs = np.empty((len(offsets),) + shape, dtype=dtype)
    coeffs[0] = 2.0 * d
    coeffs[1:] = -1.0
    for k, off in enumerate(offsets[1:], start=1):
        for axis, o in enumerate(off):
            if o == 0:
                continue
            idx = [slice(None)] * d
            idx[axis] = slice(0, 1) if o == -1 else slice(shape[axis] - 1, None)
            coeffs[(k,) + tuple(idx)] = 0.0
    return offsets, coeffs


def poisson_ell_device(shape, dtype=None, *, device=None):
    """The Poisson operator assembled by tensor code on ``device`` (CUDA when
    None; the package's device rule) straight into the slot-major
    :class:`~openmg_tpu_torch.ops.sparse.ELLMatrix`, for sizes where host
    scipy assembly is slow (at 256³ the CSR is about 1.4 GB of host work).

    Slot order is the CSR column order (offsets ascending) and pad entries
    carry ``data == 0`` at column 0: equal to
    ``ell_from_scipy(poisson(shape))``.
    """
    import torch

    from openmg_tpu_torch.core.solver import _resolve_device
    from openmg_tpu_torch.ops.sparse import ELLMatrix

    device = _resolve_device(device)
    dtype = dtype or torch.float32
    shape = tuple(int(s) for s in shape)
    d = len(shape)
    n = int(np.prod(shape))
    strides = [int(np.prod(shape[a + 1:])) for a in range(d)]
    # (offset, axis) slots sorted by signed offset, the diagonal in the middle
    offs = sorted(
        [(-strides[a], a) for a in range(d)]
        + [(0, -1)]
        + [(strides[a], a) for a in range(d)]
    )
    r = torch.arange(n, dtype=torch.int32, device=device)
    data = torch.empty((len(offs), n), dtype=dtype, device=device)
    cols = torch.empty((len(offs), n), dtype=torch.int32, device=device)
    for j, (off, a) in enumerate(offs):
        if a < 0:
            data[j] = 2.0 * d
            cols[j] = r
            continue
        c_a = (r // strides[a]) % shape[a] + (1 if off > 0 else -1)
        exists = (c_a >= 0) & (c_a < shape[a])
        data[j] = torch.where(exists, -1.0, 0.0).to(dtype)
        cols[j] = torch.where(exists, r + off, 0)
    # true nnz: the diagonal plus two off-diagonals per axis, less boundaries
    nnz = n + sum(2 * n * (shape[a] - 1) // shape[a] for a in range(d))
    return ELLMatrix(
        data=data,
        cols=cols,
        shape=(n, n),
        nnz=int(nnz),
        bandwidth=strides[0] if d else 0,
        slot_offsets=tuple(off for off, _ in offs),
    )


def stencil_to_csr(offsets, coeffs) -> sp.csr_matrix:
    """Materialize a stencil operator as scipy CSR (oracles, tests and the
    coarsest-level dense inverse)."""
    coeffs = np.asarray(coeffs)
    shape = coeffs.shape[1:]
    n = int(np.prod(shape))
    rows_list, cols_list, vals_list = [], [], []
    grid = np.indices(shape)  # (d, *shape)
    flat_rows = np.arange(n).reshape(shape)
    for k, off in enumerate(offsets):
        nbr = grid + np.asarray(off).reshape((-1,) + (1,) * len(shape))
        valid = np.ones(shape, dtype=bool)
        for axis, s in enumerate(shape):
            valid &= (nbr[axis] >= 0) & (nbr[axis] < s)
        vals = coeffs[k][valid]
        nz = vals != 0
        cols = np.ravel_multi_index(
            tuple(nbr[axis][valid] for axis in range(len(shape))), shape
        )
        rows_list.append(flat_rows[valid][nz])
        cols_list.append(cols[nz])
        vals_list.append(vals[nz])
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = np.concatenate(vals_list)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def stencil_from_csr(A, shape, max_offsets: int = 125):
    """Extract the exact stencil (DIA-on-grid) form of a grid-structured
    sparse matrix.

    Every sparse matrix whose row/column indices live on a regular grid of
    ``shape`` is exactly representable as a set of per-offset coefficient
    arrays; the number of distinct multi-index offsets must stay bounded
    (``max_offsets``) or a ``ValueError`` is raised.
    """
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    A = sp.csr_matrix(A)
    if A.shape != (n, n):
        raise ValueError(f"matrix shape {A.shape} != grid size {n}")
    coo = A.tocoo()
    rc = np.stack(np.unravel_index(coo.row, shape), axis=1)  # (nnz, d)
    cc = np.stack(np.unravel_index(coo.col, shape), axis=1)
    deltas = cc - rc  # (nnz, d)
    uniq, inverse = np.unique(deltas, axis=0, return_inverse=True)
    if len(uniq) > max_offsets:
        raise ValueError(
            f"matrix has {len(uniq)} distinct grid offsets (> {max_offsets}); "
            "not stencil-representable within budget"
        )
    offsets = tuple(tuple(int(v) for v in row) for row in uniq)
    coeffs = np.zeros((len(offsets),) + shape, dtype=coo.data.dtype)
    flat = coeffs.reshape(len(offsets), n)
    # accumulate (duplicates summed, matching CSR semantics)
    np.add.at(flat, (np.asarray(inverse).reshape(-1), coo.row), coo.data)
    # put the zero offset first if present (diagonal-first convention)
    zero = (0,) * len(shape)
    if zero in offsets:
        z = offsets.index(zero)
        if z != 0:
            order = [z] + [i for i in range(len(offsets)) if i != z]
            offsets = tuple(offsets[i] for i in order)
            coeffs = coeffs[order]
    return offsets, coeffs


def diffusion_stencil(kappa, harmonic: bool = True, dtype=np.float64):
    """Variable-coefficient diffusion operator ``−∇·(κ∇u)`` on a regular
    grid (Dirichlet), finite-volume form with face coefficients.

    ``kappa``: positive cell coefficient field, shape = grid shape.  Face
    coefficient between neighbouring cells is the harmonic (default) or
    arithmetic mean — harmonic is the standard finite-volume choice for
    discontinuous media.  Returns ``(offsets, coeffs)`` with the diagonal
    equal to the sum of the face coefficients (an SPD M-matrix; reduces
    exactly to :func:`poisson_stencil` for ``kappa ≡ 1``).
    """
    kappa = np.asarray(kappa, dtype=dtype)
    if np.any(kappa <= 0):
        raise ValueError("kappa must be strictly positive")
    shape = kappa.shape
    d = len(shape)
    offsets = poisson_offsets(d)
    coeffs = np.zeros((len(offsets),) + shape, dtype=dtype)

    def face(a, b):
        return 2.0 * a * b / (a + b) if harmonic else 0.5 * (a + b)

    k = 1
    for axis in range(d):
        lo = [slice(None)] * d
        hi = [slice(None)] * d
        lo[axis] = slice(0, shape[axis] - 1)
        hi[axis] = slice(1, None)
        f = face(kappa[tuple(lo)], kappa[tuple(hi)])  # interior faces
        # offsets ordered (-1) then (+1) per axis (poisson_offsets)
        coeffs[(k,) + tuple(hi)] = -f  # coupling to the −1 neighbour
        coeffs[(k + 1,) + tuple(lo)] = -f  # coupling to the +1 neighbour
        k += 2
        # boundary faces (Dirichlet): cell couples to the wall with its
        # own κ, contributing to the diagonal only
        wall_lo = [slice(None)] * d
        wall_lo[axis] = slice(0, 1)
        wall_hi = [slice(None)] * d
        wall_hi[axis] = slice(shape[axis] - 1, None)
        coeffs[0][tuple(wall_lo)] += kappa[tuple(wall_lo)]
        coeffs[0][tuple(wall_hi)] += kappa[tuple(wall_hi)]
    # diagonal = − Σ off-diagonal couplings + boundary terms
    coeffs[0] += -np.sum(coeffs[1:], axis=0)
    return offsets, coeffs


def diffusion(kappa, harmonic: bool = True) -> sp.csr_matrix:
    """CSR form of :func:`diffusion_stencil` (oracle/interchange)."""
    offsets, coeffs = diffusion_stencil(kappa, harmonic)
    return stencil_to_csr(offsets, coeffs)


def rhs_random(shape, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Reproducible random right-hand side on the grid."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(tuple(int(s) for s in shape)).astype(dtype)


def rhs_ones(shape, dtype=np.float64) -> np.ndarray:
    return np.ones(tuple(int(s) for s in shape), dtype=dtype)
