"""Cycle engine (twin of ``openmg_tpu/core/cycle.py``): the V-cycle.

The recursion runs over the static level list as plain Python.  On a
constant or cornered level a visit is one call of the fused kernel (K1 in
3D, K5 in 2D) on the way down (pre-smoothing from a zero start + residual +
restriction) and one on the way up (prolongation + add + post-smoothing).
A 2D visit with no post-smoothing takes the tensor ``prolong`` and add, and
one with no pre-smoothing the per-pass residual and the tensor
``restrict``, as in the JAX package, whose 2D kernel needs stages.  On a
level the fused kernel does not take (varying coefficients) the visit is
composed from ``smooth``, ``residual``, ``restrict`` and ``prolong``: the
first two are the per-pass kernel on the card, the transfers are tensor
code on any device, as they are array code outside any kernel in the JAX
package.  The coarsest level is one matrix–vector product with the
precomputed dense inverse.

A varying level's legs (the pre-smoothing from zero with the residual,
and the post-smoothing) are one call each of
:func:`~openmg_tpu_torch.ops.kernels.sweeps_vary_3d` on every device:
launches of K4 of up to ``leg_depth`` passes each on the card, its plain
loop of passes on the CPU.

Ported: ``coarse_solve``, ``v_cycle`` with ``x_zero`` and ``gamma=1``,
``run_cycle("v")``.  W-cycles, FMG and ``pcg_solve`` wait for a later slice
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from openmg_tpu_torch.core.hierarchy import Hierarchy
from openmg_tpu_torch.ops import fused, kernels
from openmg_tpu_torch.ops.smoothers import smooth
from openmg_tpu_torch.ops.stencil import (
    StencilOperator,
    _on_cpu,
    kernel_operands_ok,
    residual,
)
from openmg_tpu_torch.ops.sparse import matvec_full
from openmg_tpu_torch.ops.transfer import prolong, restrict

__all__ = ["v_cycle", "coarse_solve", "run_cycle", "fmg_cycle", "pcg_solve"]

_LATER = "is not ported yet (ROADMAP queue 1, item 14: FMG, W-cycle, PCG)"


def coarse_solve(hierarchy: Hierarchy, b: torch.Tensor) -> torch.Tensor:
    """Direct solve at the coarsest level via the precomputed dense inverse:
    one matrix–vector product, left to the library as the JAX package
    leaves it to its compiler, in full float32 (never TF32)."""
    return matvec_full(hierarchy.coarse_inv, b.reshape(-1)).reshape(b.shape)


def _vary_leg(op, smoother, b) -> bool:
    """Whether a visit of ``op`` runs as legs of
    :func:`~openmg_tpu_torch.ops.kernels.sweeps_vary_3d`: a varying
    operator with a Jacobi or red/black smoother.  On the card what the
    kernel does not take raises (a float64 cycle does)."""
    if not (
        smoother in ("jacobi", "rbgs")
        and isinstance(op, StencilOperator) and not op.is_constant
    ):
        return False
    if not _on_cpu(b):
        why = kernel_operands_ok(op, b)
        if why is not None:
            raise NotImplementedError(
                f"a varying level visit on {b.device}: {why} is not taken by "
                "the leg kernel, and plain tensor code does not run on the card"
            )
    return True


def v_cycle(
    hierarchy: Hierarchy,
    b,
    x,
    level: int = 0,
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
    gamma: int = 1,
    x_zero: bool = False,
):
    """One V-cycle starting at ``level``; returns the improved ``x``.

    ``x_zero`` declares that ``x`` is all-zero — true at every level of the
    defect-correction cycle (the fine level solves ``A e = r`` from zero;
    each coarse visit starts from a zero correction).  The pre-smoothing
    then reads only ``b``, and ``x`` may be None.

    A varying level's visit is two legs of ``sweeps_vary_3d``.  Any
    other visit goes to the fused kernel first.  Where its entry point
    declines a case (it returns None: a varying operator, a non-float32
    grid, a smoother that is not a stage list, an odd dimension with a
    transfer, a 2D leg with no stages) the visit is composed from ``smooth``
    and ``residual``, which on the card launch the per-pass kernel or raise
    (a float64 cycle does), and the tensor transfers.
    """
    if gamma != 1:
        raise NotImplementedError(f"gamma={gamma} (W-cycle) {_LATER}")
    if x is None and not x_zero:
        raise ValueError("x=None needs x_zero=True")
    L = hierarchy.levels[level]
    if level == hierarchy.num_levels - 1:
        return coarse_solve(hierarchy, b)
    tr = hierarchy.transfer
    leg = _vary_leg(L.A, smoother, b)
    # a red/black sweep is two passes of the leg kernel
    per = 2 if smoother == "rbgs" else 1
    if leg:
        x, r = kernels.sweeps_vary_3d(
            L.A.coeffs, L.A.offsets, b, None if x_zero else x, pre * per,
            smoother, omega, emit_residual=True, inv_diag=L.inv_diag,
        )
        out = x, restrict(r, tr)
    elif pre > 0:
        out = fused.presmooth_restrict_fused(
            smoother, L.A, b, None if x_zero else x, pre, omega, tr
        )
    else:
        if x is None:
            x = torch.zeros_like(b)
        bc = fused.residual_restrict_fused(L.A, b, x, tr)
        out = None if bc is None else (x, bc)
    if out is None:
        if x is None:
            x = torch.zeros_like(b)
        x = smooth(smoother, L.A, L.inv_diag, b, x, pre, omega)
        out = x, restrict(residual(L.A, b, x), tr)
    x, bc = out
    # every coarse visit starts from a zero correction: declared, not stored
    ec = v_cycle(
        hierarchy, bc, None, level + 1, pre, post, smoother, omega, gamma,
        x_zero=True,
    )
    # post == 0 is the kernel's stage-free mode: prolongation and add alone
    if leg:
        x = x + prolong(ec, L.grid_shape, tr)
        return kernels.sweeps_vary_3d(
            L.A.coeffs, L.A.offsets, b, x, post * per, smoother, omega,
            inv_diag=L.inv_diag,
        )
    y = fused.prolong_smooth_fused(smoother, L.A, b, x, ec, post, omega, tr)
    if y is None:
        x = x + prolong(ec, L.grid_shape, tr)
        y = smooth(smoother, L.A, L.inv_diag, b, x, post, omega)
    return y


def fmg_cycle(*args, **kwargs):
    raise NotImplementedError(f"fmg_cycle {_LATER}")


def pcg_solve(*args, **kwargs):
    raise NotImplementedError(f"pcg_solve {_LATER}")


def run_cycle(
    hierarchy: Hierarchy,
    r,
    cycle_type: str = "v",
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
):
    """Error-correction cycle ``e ≈ A⁻¹ r`` from zero, by cycle type."""
    if cycle_type == "v":
        # the zero start is declared, so the iterate argument is never read
        return v_cycle(
            hierarchy, r, None, 0, pre, post, smoother, omega, 1, x_zero=True
        )
    if cycle_type in ("w", "f"):
        raise NotImplementedError(f"cycle_type={cycle_type!r} {_LATER}")
    raise ValueError(f"unknown cycle_type {cycle_type!r}; choose v|w|f")
