"""Stationary smoothers on stencil operators (twin of
``openmg_tpu/ops/smoothers.py``), in plain tensor code.

* weighted Jacobi  ``x ← x + ω D⁻¹ (b − A x)``, and
* red–black Gauss–Seidel — update the red parity class (even coordinate
  sum) from the current iterate, then the black class.  Every point of a
  half-sweep reads the pre-half-sweep iterate.  On the (2d+1)-point
  operators this is exactly Gauss–Seidel in red-black ordering; on the
  27-point Galerkin levels same-colour points are coupled and the
  half-sweep is a coloured Jacobi step, as in the JAX package.

:func:`jacobi` and :func:`rbgs` are written through
:func:`openmg_tpu_torch.ops.stencil.residual` (``x_i + r_i / a_ii``), with
the exact per-point diagonal on cornered and varying operators.  That makes
them a formulation independent of the pass-by-pass plain versions in
:mod:`openmg_tpu_torch.ops.fused` and :mod:`openmg_tpu_torch.ops.kernels`,
which the tests hold against them.

:func:`smooth` dispatches on the device of ``b``: CPU tensors take
``jacobi`` / ``rbgs``; on the card a constant or cornered operator goes to
the fused kernel first (K1 in 3D, K5 in 2D) and to the per-pass kernel (K3,
a 2D operand lifted to ``(1, ny, nx)``) where that declines, a varying
operator to the per-pass kernel (K4), and what neither takes raises.
Chebyshev smoothing and faced operators wait for a later slice.
"""

from __future__ import annotations

import torch

from openmg_tpu_torch.ops import stencil as _stencil
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
    full grid for a varying one and for a cornered one (interior value,
    region-table value on the low faces/edges/corner)."""
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


def _smooth_kernel(name, op, b, x, iterations, omega):
    """``smooth`` through the kernels, or raise: nothing here is plain
    tensor code."""
    from openmg_tpu_torch.ops import fused, kernels

    if name == "chebyshev":
        raise NotImplementedError(
            "the chebyshev smoother is not ported (ROADMAP queue 1, item 15)"
        )
    if name not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {name!r}")
    why = _stencil.kernel_operands_ok(op, x)
    if why is not None:
        raise NotImplementedError(
            f"smooth on {b.device}: {why} is not taken by the smoother "
            "kernels, and plain tensor code does not run on the card"
        )
    if isinstance(op, CorneredOperator) or op.is_constant:
        y = fused.smooth_fused(name, op, b, x, iterations, omega)
        if y is not None:
            return y
        corner = fused._corner_info(op)
        if name == "jacobi":
            return kernels.jacobi_const_3d(
                op.values, op.offsets, b, x, iterations, omega, corner=corner
            )
        return kernels.rbgs_const_3d(
            op.values, op.offsets, b, x, iterations, corner=corner
        )
    if name == "jacobi":
        return kernels.jacobi_vary_3d(op.coeffs, op.offsets, b, x, iterations, omega)
    return kernels.rbgs_vary_3d(op.coeffs, op.offsets, b, x, iterations)


def smooth(name: str, op, inv_diag, b, x, iterations: int, omega: float):
    if iterations <= 0:
        return x
    if not _stencil._on_cpu(b):
        return _smooth_kernel(name, op, b, x, iterations, omega)
    if name == "jacobi":
        return jacobi(op, inv_diag, b, x, iterations, omega)
    if name == "rbgs":
        return rbgs(op, inv_diag, b, x, iterations)
    if name == "chebyshev":
        raise NotImplementedError(
            "the chebyshev smoother is not ported (ROADMAP queue 1, item 15)"
        )
    raise ValueError(f"unknown smoother {name!r}")
