"""Stationary smoothers on stencil operators (twin of
``openmg_tpu/ops/smoothers.py``), in plain tensor code.

* weighted Jacobi  ``x ← x + ω D⁻¹ (b − A x)``, and
* red–black Gauss–Seidel — update the red parity class (even coordinate
  sum) from the current iterate, then the black class.  Every point of a
  half-sweep reads the pre-half-sweep iterate.  On the (2d+1)-point
  operators this is exactly Gauss–Seidel in red-black ordering; on the
  27-point Galerkin levels same-colour points are coupled and the
  half-sweep is a coloured Jacobi step, as in the JAX package.

Both are written through :func:`openmg_tpu_torch.ops.stencil.residual`
(``x_i + r_i / a_ii``), with the exact per-point diagonal on cornered
operators.  That makes them a formulation independent of the stage-by-stage
plain version in :mod:`openmg_tpu_torch.ops.fused`, which the tests hold
against them.  On the card the V-cycle goes through the fused kernel, not
through this module.  Chebyshev smoothing and faced operators wait for a
later slice.
"""

from __future__ import annotations

import torch

from openmg_tpu_torch.ops.stencil import (
    CorneredOperator,
    StencilOperator,
    diag_index,
    residual,
)

__all__ = ["jacobi", "rbgs", "smooth", "red_mask", "diag_full"]


def red_mask(shape, device="cpu") -> torch.Tensor:
    """Boolean grid, True where the coordinate sum is even (red)."""
    shape = tuple(int(s) for s in shape)
    acc = None
    for a, s in enumerate(shape):
        view = [1] * len(shape)
        view[a] = -1
        par = (torch.arange(s, device=device) & 1).reshape(view)
        acc = par if acc is None else acc ^ par
    return acc == 0


def diag_full(op):
    """The operator's diagonal: a 0-d tensor for a constant operator, the
    full grid (interior value, region-table value on the low
    faces/edges/corner) for a cornered one."""
    di = diag_index(op.offsets)
    if isinstance(op, CorneredOperator):
        d = torch.zeros(op.shape, dtype=op.dtype, device=op.device) + op.values[di]
        tbl = op.table
        for r, R in enumerate(op.regions):
            idx = tuple(
                slice(0, 1) if b in R else slice(None)
                for b in range(len(op.shape))
            )
            d[idx] = tbl[r, di]
        return d
    if isinstance(op, StencilOperator):
        return op.coeff(di)
    raise NotImplementedError(
        f"{type(op).__name__} smoothing is not ported (ROADMAP queue 1, slice B)"
    )


def jacobi(op, inv_diag, b, x, iterations: int, omega: float = 2.0 / 3.0):
    """``iterations`` weighted-Jacobi sweeps.  ``inv_diag`` is accepted for
    signature parity with the JAX package; the exact diagonal is taken
    from the operator."""
    d = diag_full(op)
    for _ in range(iterations):
        x = x + omega * (residual(op, b, x) / d)
    return x


def rbgs(op, inv_diag, b, x, iterations: int):
    """Red–black Gauss–Seidel sweeps (two half-sweeps each)."""
    d = diag_full(op)
    mask = red_mask(x.shape, x.device)
    for _ in range(iterations):
        for m in (mask, ~mask):
            xn = x + residual(op, b, x) / d
            x = torch.where(m, xn, x)
    return x


def smooth(name: str, op, inv_diag, b, x, iterations: int, omega: float):
    if iterations <= 0:
        return x
    if name == "jacobi":
        return jacobi(op, inv_diag, b, x, iterations, omega)
    if name == "rbgs":
        return rbgs(op, inv_diag, b, x, iterations)
    if name == "chebyshev":
        raise NotImplementedError(
            "the chebyshev smoother is not ported (ROADMAP queue 1, item 15)"
        )
    raise ValueError(f"unknown smoother {name!r}")
