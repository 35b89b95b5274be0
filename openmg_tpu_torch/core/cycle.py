"""Cycle engine (twin of ``openmg_tpu/core/cycle.py``): V, W and FMG
cycles, and MG-preconditioned CG.

The recursion runs over the static level list as plain Python.  On a
constant or cornered level a visit is one call of the fused kernel (K1 in
3D, K5 in 2D) on the way down (pre-smoothing from a zero start or from an
iterate + residual + restriction) and one on the way up (prolongation +
add + post-smoothing).
A 2D visit with no post-smoothing takes the tensor ``prolong`` and add, and
one with no pre-smoothing the per-pass residual and the tensor
``restrict``, as in the JAX package, whose 2D kernel needs stages.  On a
level the fused kernel does not take (varying coefficients) the visit is
composed from ``smooth``, ``residual``, ``restrict`` and ``prolong``: the
first two are the per-pass kernel on the card, the transfers are tensor
code on any device, as they are array code outside any kernel in the JAX
package.  The coarsest level is one matrix–vector product with the
precomputed dense inverse.

The fused kernels take stage lists only, so a Chebyshev visit (and any
visit of a faced level) is composed too: ``smooth`` (on the card one
per-pass residual launch, K3 or K4, a Chebyshev iteration; a faced level's
Jacobi or red/black passes are K3's constant passes with the face rows
rewritten in tensor code), ``residual`` and the tensor ``restrict``, as the
JAX package composes it.  A 1D level takes the same composed visit: the
fused kernels take 2D and 3D grids, the per-pass kernel takes the 1D grid
on its lift to ``(1, 1, n)``.

A varying level's legs (the pre-smoothing from zero or from an iterate
with the residual, and the post-smoothing) are one call each of
:func:`~openmg_tpu_torch.ops.kernels.sweeps_vary_3d` on every device:
launches of K4 of up to ``leg_depth`` passes each on the card, its plain
loop of passes on the CPU.

A W-cycle (``gamma=2``) visits the coarser level twice, the second time
from the first visit's correction: that visit's down-leg starts from an
iterate (K1, K5 or the leg kernel K4 with ``x`` and the residual).  FMG
restricts ``b`` to every level with the tensor transfers, solves the
coarsest exactly and runs one V-cycle from the prolonged iterate on each
level upward.  ``pcg_solve`` runs CG steps preconditioned by one cycle
each; its ``A p`` is the tensor ``apply`` on the fine level and its inner
products stay float32 tensors on the device (no host read).

**A batch** ``(K, *grid)`` of right-hand sides (``Solver.solve_many``, the
JAX package's ``vmap`` of the whole solve) runs every function here at
once: it is a batch where the tensor has one more axis than the level's
grid.  Every visit runs the batch as one stack through the code the scalar
visit runs, each kernel in its batched form: K1b or K5b where the fused
kernel takes the visit, K4b's legs on a varying level, K3b or K4b passes
on a composed (Chebyshev, faced, 1D) one; the transfers, FMG's included,
and PCG's ``A p`` are tensor code on the stack.  Only the coarsest level's
product goes member by member: a matrix product over the batch need not
keep the bits of each column's matrix–vector product.  PCG's inner
products, ``alpha`` and ``beta`` are ``(K,)`` tensors, each member's taken
by the scalar path's own call on its rows, so every member is bit-equal to
its scalar cycle.
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
from openmg_tpu_torch.ops.stencil import apply as stencil_apply
from openmg_tpu_torch.ops.sparse import matvec_full
from openmg_tpu_torch.ops.transfer import prolong, restrict

__all__ = ["v_cycle", "coarse_solve", "run_cycle", "fmg_cycle", "pcg_solve"]


def _is_batch(hierarchy: Hierarchy, level: int, t) -> bool:
    """Whether ``t`` is a batch of level ``level``'s grids: one axis more
    than the grid (the level's dimension decides, not the tensor's)."""
    return t.ndim == len(hierarchy.levels[level].grid_shape) + 1


def coarse_solve(hierarchy: Hierarchy, b: torch.Tensor) -> torch.Tensor:
    """Direct solve at the coarsest level via the precomputed dense inverse:
    one matrix–vector product, left to the library as the JAX package
    leaves it to its compiler, in full float32 (never TF32).  A batch takes
    one product a member: a matrix product over the batch need not keep the
    bits of each column's matrix–vector product."""
    if _is_batch(hierarchy, hierarchy.num_levels - 1, b):
        return torch.stack([coarse_solve(hierarchy, bm) for bm in b])
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


def _legs(b, L):
    """K4's leg function for ``b``: the batched form for a batch of
    ``L``'s grids, else the scalar one."""
    if b.ndim == len(L.grid_shape) + 1:
        return kernels.sweeps_vary_batch
    return kernels.sweeps_vary_3d


def _down(L, b, x, x_zero, pre, smoother, omega, tr):
    """A level visit's way down: pre-smoothing from zero or from ``x``, the
    residual and its restriction.  Returns ``(x, bc)``.  A batch takes the
    same path in the kernels' batched forms."""
    nd = len(L.grid_shape)
    # a red/black sweep is two passes of the leg kernel
    per = 2 if smoother == "rbgs" else 1
    if _vary_leg(L.A, smoother, b):
        x, r = _legs(b, L)(
            L.A.coeffs, L.A.offsets, b, None if x_zero else x, pre * per,
            smoother, omega, emit_residual=True, inv_diag=L.inv_diag,
        )
        return x, restrict(r, tr, nd)
    if pre > 0:
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
        out = x, restrict(residual(L.A, b, x), tr, nd)
    return out


def _up(L, b, x, ec, post, smoother, omega, tr):
    """A level visit's way up: ``x + P ec`` and the post-smoothing (post
    == 0 is the kernel's stage-free mode: prolongation and add alone).  A
    batch takes the same path in the kernels' batched forms."""
    if _vary_leg(L.A, smoother, b):
        per = 2 if smoother == "rbgs" else 1
        x = x + prolong(ec, L.grid_shape, tr)
        return _legs(b, L)(
            L.A.coeffs, L.A.offsets, b, x, post * per, smoother, omega,
            inv_diag=L.inv_diag,
        )
    y = fused.prolong_smooth_fused(smoother, L.A, b, x, ec, post, omega, tr)
    if y is None:
        x = x + prolong(ec, L.grid_shape, tr)
        y = smooth(smoother, L.A, L.inv_diag, b, x, post, omega)
    return y


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
    """One µ-cycle starting at ``level`` (``gamma=1``: V, 2: W); returns the
    improved ``x``.

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
    (a float64 cycle does), and the tensor transfers.  ``b`` (and ``x``)
    may be a batch ``(K, *grid)``: see the module's note.
    """
    if x is None and not x_zero:
        raise ValueError("x=None needs x_zero=True")
    L = hierarchy.levels[level]
    if level == hierarchy.num_levels - 1:
        return coarse_solve(hierarchy, b)
    tr = hierarchy.transfer
    x, bc = _down(L, b, x, x_zero, pre, smoother, omega, tr)
    # µ visits; the first starts from a zero correction (declared, not
    # stored), a second from the first's.  At the level just above the
    # coarsest a second visit would re-run the exact solve on an unchanged
    # residual, so W-cycles visit it once, as the JAX package does.
    visits = 1 if level == hierarchy.num_levels - 2 else gamma
    ec = None
    for v in range(visits):
        ec = v_cycle(
            hierarchy, bc, ec, level + 1, pre, post, smoother, omega, gamma,
            x_zero=(v == 0),
        )
    return _up(L, b, x, ec, post, smoother, omega, tr)


def fmg_cycle(
    hierarchy: Hierarchy,
    b,
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
    gamma: int = 1,
):
    """One full-multigrid pass for ``A x = b`` from a zero initial guess:
    restrict ``b`` to every level, solve the coarsest exactly, then
    prolong upward with one µ-cycle per level from that iterate."""
    tr = hierarchy.transfer
    nd = len(hierarchy.levels[0].grid_shape)
    bs = [b]
    for _ in range(hierarchy.num_levels - 1):
        bs.append(restrict(bs[-1], tr, nd))
    x = coarse_solve(hierarchy, bs[-1])
    for lvl in range(hierarchy.num_levels - 2, -1, -1):
        x = prolong(x, hierarchy.levels[lvl].grid_shape, tr)
        x = v_cycle(hierarchy, bs[lvl], x, lvl, pre, post, smoother, omega, gamma)
    return x


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
    if cycle_type in ("v", "w"):
        # the zero start is declared, so the iterate argument is never read
        return v_cycle(
            hierarchy, r, None, 0, pre, post, smoother, omega,
            1 if cycle_type == "v" else 2, x_zero=True,
        )
    if cycle_type == "f":
        return fmg_cycle(hierarchy, r, pre, post, smoother, omega, 1)
    raise ValueError(f"unknown cycle_type {cycle_type!r}; choose v|w|f")


def pcg_solve(
    hierarchy: Hierarchy,
    r0,
    iters: int = 2,
    cycle_type: str = "v",
    pre: int = 2,
    post: int = 2,
    smoother: str = "rbgs",
    omega: float = 2.0 / 3.0,
):
    """``iters`` steps of conjugate gradients on ``A e = r0`` from zero,
    each preconditioned by one multigrid cycle of ``cycle_type``: the inner
    error solver of the defect-correction loop with ``krylov="pcg"`` (the
    outer loop tolerates the nonlinear inner map).  ``A p`` is the tensor
    :func:`~openmg_tpu_torch.ops.stencil.apply` on the fine level; ``rz``,
    ``p·Ap``, ``alpha`` and ``beta`` are float32 0-d tensors, never read to
    the host; on a batch ``(K,)`` tensors, a member's taken by the scalar
    call on its rows (``torch.sum`` of the member's products), and ``A p``
    is tensor code on the stack."""
    A = hierarchy.levels[0].A
    batch = _is_batch(hierarchy, 0, r0)
    lift = (-1,) + (1,) * (r0.ndim - 1)

    def precond(rr):
        return run_cycle(hierarchy, rr, cycle_type, pre, post, smoother, omega)

    def dot(u, v):
        if not batch:
            return torch.sum(u * v)
        return torch.stack([torch.sum(w) for w in u * v]).reshape(lift)


    e = torch.zeros_like(r0)
    r = r0
    z = precond(r)
    p = z
    rz = dot(r, z)
    for it in range(iters):
        Ap = stencil_apply(A, p)
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
