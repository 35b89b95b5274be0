"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Every input is made with numpy from a seed and handed to both packages: as
a float32 ``jnp`` array to the JAX package (``tests/conftest.py`` enables
x64, so the cast is explicit) and as a float32 CPU tensor to the port.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# the test run uses several worker processes; one thread each is enough at
# these sizes and keeps them from oversubscribing the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """numpy's BLAS on one thread while a port test module runs (each
    ``tests/test_torch_*.py`` imports this fixture).  Its default, a thread
    per core in every test worker, spins and doubled the CPU time of the
    port's tests beside the JAX package's; the limit is lifted when the
    module ends, so the JAX package's own test files keep their setting."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1, user_api="blas"):
        yield


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_t(a):
    """numpy → float32 CPU tensor (None passes through)."""
    if a is None:
        return None
    return torch.from_numpy(np.array(a, dtype=np.float32))


def to_j(a):
    """numpy → float32 jnp array (None passes through)."""
    import jax.numpy as jnp

    if a is None:
        return None
    return jnp.asarray(np.asarray(a), dtype=jnp.float32)


def to_n(a):
    """tensor or jax array → numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(got, ref, factor=2e-6, what="", scale=None):
    """|got − ref| ≤ factor · max|ref| everywhere (absolute, scaled by the
    reference's size: float32 sums taken in another order).  ``scale``
    replaces ``ref`` as the array whose largest entry sets the scale, for a
    result that is a small difference of larger terms (a residual after
    smoothing carries the rounding of ``b`` and ``A x``, not of itself)."""
    got, ref = to_n(got), to_n(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    size = to_n(scale) if scale is not None else ref
    tol = factor * max(float(np.max(np.abs(size))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - ref.astype(np.float64))))
    assert err <= tol, f"{what}: max err {err:.3e} > {tol:.3e}"


def port_op(op, device="cpu"):
    """The port's operator for a JAX-package constant, cornered, faced or
    varying operator (tables copied as numpy)."""
    from openmg_tpu.ops.stencil import CorneredOperator as JC
    from openmg_tpu.ops.stencil import FacedStencilOperator as JF
    from openmg_tpu_torch.ops.stencil import (
        CorneredOperator,
        FacedStencilOperator,
        StencilOperator,
    )

    offsets = tuple(tuple(int(o) for o in off) for off in op.offsets)
    shape = tuple(int(s) for s in op.grid_shape)
    if isinstance(op, JF):
        return FacedStencilOperator(
            values=to_t(op.values).to(device),
            face_coeffs=tuple(to_t(p).to(device) for p in op.face_coeffs),
            offsets=offsets,
            shape=shape,
            face_axes=tuple(int(a) for a in op.face_axes),
        )
    if not isinstance(op, JC) and not op.is_constant:
        return StencilOperator(to_t(op.coeffs).to(device), offsets)
    if isinstance(op, JC):
        return CorneredOperator(
            values=to_t(op.values).to(device),
            deltas=to_t(op.deltas).to(device),
            offsets=offsets,
            shape=shape,
            subsets=tuple(tuple(S) for S in op.subsets),
        )
    return StencilOperator(None, offsets, to_t(op.values).to(device), shape)


def _op_spec(A):
    """A plain (constant or varying) JAX-package operator as numpy."""
    d = {"offsets": tuple(A.offsets), "shape": tuple(A.grid_shape)}
    if A.is_constant:
        d["values"] = np.asarray(A.values)
    else:
        d["coeffs"] = np.asarray(A.coeffs)
    return d


def spec_from_jax_hierarchy(h):
    """Plain-numpy ``spec`` of a JAX-package hierarchy, in the layout of
    ``openmg_tpu_torch.utils.convert.hierarchy_from_numpy``."""
    from openmg_tpu.ops.stencil import CorneredOperator as JC
    from openmg_tpu.ops.stencil import FacedStencilOperator as JF

    levels = []
    for L in h.levels:
        A = L.A
        if isinstance(A, JF):
            lv = {
                "kind": "faced",
                "offsets": tuple(A.offsets),
                "shape": tuple(A.grid_shape),
                "values": np.asarray(A.values),
                "face_axes": tuple(A.face_axes),
                "face_coeffs": [np.asarray(p) for p in A.face_coeffs],
            }
        elif isinstance(A, JC):
            lv = {
                "kind": "cornered",
                "offsets": tuple(A.offsets),
                "shape": tuple(A.grid_shape),
                "values": np.asarray(A.values),
                "deltas": np.asarray(A.deltas),
                "subsets": tuple(A.subsets),
            }
        else:
            lv = {"kind": "const" if A.is_constant else "varying", **_op_spec(A)}
        levels.append(lv)
    spec = {
        "transfer": h.transfer.name,
        "levels": levels,
        "coarse_inv": np.asarray(h.coarse_inv),
        "stats": tuple(h.stats),
    }
    if h.fine_hi_lo is not None:
        spec["fine_hi"] = _op_spec(h.fine_hi)
        spec["fine_hi_lo"] = _op_spec(h.fine_hi_lo)
    return spec


def container_spec(M):
    """A JAX-package sparse container as numpy, in the layout of
    ``openmg_tpu_torch.utils.convert.sparse_hierarchy_from_numpy``."""
    from openmg_tpu.ops import sparse as js

    if M is None:
        return None
    if isinstance(M, js.ELLMatrix):
        return {"format": "ell", "data": np.asarray(M.data),
                "cols": np.asarray(M.cols), "shape": M.shape, "nnz": M.nnz,
                "bandwidth": M.bandwidth, "slot_offsets": M.slot_offsets}
    if isinstance(M, js.CSRMatrix):
        return {"format": "csr", "data": np.asarray(M.data),
                "indices": np.asarray(M.indices),
                "row_ids": np.asarray(M.row_ids), "shape": M.shape,
                "nnz": M.nnz}
    if isinstance(M, js.BSRMatrix):
        return {"format": "bsr", "data": np.asarray(M.data),
                "bcols": np.asarray(M.bcols), "shape": M.shape,
                "blocksize": M.blocksize, "nnz": M.nnz,
                "slot_offsets": M.slot_offsets}
    assert isinstance(M, js.DenseMatrix), type(M)
    return {"format": "dense", "data": np.asarray(M.data), "nnz": M.nnz}


def sparse_spec_from_jax_hierarchy(h):
    """Plain-numpy ``spec`` of a JAX-package ``SparseHierarchy``."""
    levels = [
        {"A": container_spec(L.A), "inv_diag": np.asarray(L.inv_diag),
         "R": container_spec(L.R), "P": container_spec(L.P),
         "colors": None if L.colors is None else np.asarray(L.colors),
         "num_colors": L.num_colors, "lam_max": float(L.lam_max)}
        for L in h.levels
    ]
    return {
        "fmt": h.fmt, "shapes": h.shapes, "transfer_name": h.transfer_name,
        "dofs": h.dofs, "stats": h.stats, "levels": levels,
        "coarse_inv": np.asarray(h.coarse_inv),
        "fine_hi": container_spec(h.fine_hi),
        "fine_lo": container_spec(h.fine_lo),
    }


def non_stencil_spd(shape, seed=0):
    """Poisson plus weak random long-range symmetric couplings (the matrix
    of ``tests/test_algebraic.py``): SPD, not stencil-representable."""
    import scipy.sparse as sp

    from openmg_tpu_torch.models.poisson import poisson

    A = sp.lil_matrix(poisson(shape).astype(np.float64))
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    for i, j in zip(rng.integers(0, n, size=4 * n), rng.integers(0, n, size=4 * n)):
        if i == j:
            continue
        A[i, j] += -0.01
        A[j, i] += -0.01
        A[i, i] += 0.01
        A[j, j] += 0.01
    return sp.csr_matrix(A)
