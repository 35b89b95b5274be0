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

:func:`chebyshev` is the 4th-kind Chebyshev polynomial smoother with a
Gershgorin bound on λmax(D⁻¹A) (:func:`gershgorin_lambda_max`): each
iteration's ``r ← r − A d`` is one :func:`~openmg_tpu_torch.ops.stencil.
residual`, the ``d`` and ``x`` updates are tensor code, as they are array
code in the JAX package.

:func:`smooth` dispatches on the device of ``b``: CPU tensors take
``jacobi`` / ``rbgs`` / ``chebyshev``; on the card a constant or cornered
operator goes to the fused kernel first (K1 in 3D, K5 in 2D) and to the
per-pass kernel (K3, a 1D or 2D operand lifted to ``(1, 1, n)`` or ``(1,
ny, nx)``) where that declines, a varying operator to the per-pass kernel
(K4), and what neither takes raises.  A faced operator
(:class:`~openmg_tpu_torch.ops.stencil.FacedStencilOperator`) takes K3's
constant passes one at a time on either device (the plain version on the
CPU) and its face planes in tensor code after each, as in the JAX package.
Chebyshev on the card is one per-pass residual launch (K3, or K4 on a
varying level) an iteration; its λmax and full inverse diagonal are
computed once per operator and kept as device tensors, never read to the
host.

Every smoother takes a batch ``(K, *grid)`` of ``op``'s grids too
(``solve_many``): the tensor code runs on the stack, the kernels in their
batched forms (K1b/K5b where the fused kernel takes the sweeps, else K3b
or K4b passes; a Chebyshev iteration is one K3b or K4b residual launch for
the stack), and λmax and 1/diag stay one per operator.
"""

from __future__ import annotations

import torch

from openmg_tpu_torch.ops import stencil as _stencil
from openmg_tpu_torch.ops.stencil import (
    CorneredOperator,
    FacedStencilOperator,
    StencilOperator,
    _fix_faces,
    _once,
    diag_index,
    face_apply,
    residual,
)

__all__ = [
    "jacobi",
    "rbgs",
    "chebyshev",
    "gershgorin_lambda_max",
    "cornered_inv_diag_full",
    "smooth",
    "red_mask",
    "diag_full",
]


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
    if isinstance(op, FacedStencilOperator):
        d = torch.zeros(op.shape, dtype=op.dtype, device=op.device) + op.values[di]
        return _fix_faces(op, d, lambda fi: op.face_coeffs[fi][di])
    if isinstance(op, StencilOperator):
        return op.coeff(di)
    raise TypeError(f"no diagonal for a {type(op).__name__}")


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
    mask = red_mask(x.shape[x.ndim - op.ndim:], x.device)
    for _ in range(iterations):
        for m in (mask, ~mask):
            xn = x + residual(op, b, x) / d
            x = torch.where(m, xn, x)
    return x


def gershgorin_lambda_max(op, inv_diag):
    """Upper bound on λmax(D⁻¹A): ``max_i (1 + Σ_j≠i |a_ij| / a_ii)``, a
    0-d tensor on the operator's device.  Exactly 2 for Poisson."""
    di = diag_index(op.offsets)
    if isinstance(op, (CorneredOperator, FacedStencilOperator)):
        offsum_int = sum(
            torch.abs(op.values[k]) for k in range(op.num_offsets) if k != di
        )
        lam = 1.0 + offsum_int / torch.abs(op.values[di])
    if isinstance(op, CorneredOperator):
        tbl = op.table
        for r, R in enumerate(op.regions):
            offsum = sum(
                torch.abs(tbl[r, k])
                for k, off in enumerate(op.offsets)
                # taps reaching i_b = −1 for b ∈ R are outside the domain on
                # every row of the region: leaving them out tightens the
                # bound, which stays a bound
                if k != di and not any(off[b] < 0 for b in R)
            )
            lam = torch.maximum(lam, 1.0 + offsum / torch.abs(tbl[r, di]))
        return lam
    if isinstance(op, FacedStencilOperator):
        for fc in op.face_coeffs:
            offsum = None
            for k in range(op.num_offsets):
                if k == di:
                    continue
                t = torch.abs(fc[k])
                offsum = t if offsum is None else offsum + t
            lam = torch.maximum(lam, 1.0 + torch.max(offsum / torch.abs(fc[di])))
        return lam
    if op.is_constant:
        offsum = sum(
            torch.abs(op.values[k]) for k in range(op.num_offsets) if k != di
        )
        return 1.0 + offsum * torch.abs(inv_diag)
    offsum = None
    for k in range(op.num_offsets):
        if k == di:
            continue
        t = torch.abs(op.coeffs[k])
        offsum = t if offsum is None else offsum + t
    return 1.0 + torch.max(offsum * torch.abs(inv_diag))


def chebyshev(op, inv_diag, b, x, iterations: int, lam_max=None):
    """Fourth-kind Chebyshev polynomial smoother: ``iterations`` steps of
    ``x ← x + d_k`` with

        d_1 = 4/(3 λmax) · D⁻¹ r₀
        d_{k+1} = (2k−1)/(2k+3) · d_k + (8k+4)/((2k+3) λmax) · D⁻¹ r_k

    and ``r_k ← r_{k−1} − A d_k`` by :func:`~openmg_tpu_torch.ops.stencil.
    residual` (one per-pass kernel launch on the card).  One iteration with
    λmax = 2 is ω = 2/3 weighted Jacobi.  ``lam_max`` defaults to
    :func:`gershgorin_lambda_max`; it stays a tensor on the device."""
    if lam_max is None:
        lam_max = gershgorin_lambda_max(op, inv_diag)
    lam_max = torch.as_tensor(lam_max, dtype=x.dtype, device=x.device)
    r = residual(op, b, x)
    d = (4.0 / 3.0) / lam_max * inv_diag * r
    for k in range(1, iterations + 1):
        x = x + d
        if k == iterations:
            break
        r = residual(op, r, d)  # r ← r − A d
        d = ((2 * k - 1) / (2 * k + 3)) * d + (
            (8 * k + 4) / (2 * k + 3)
        ) / lam_max * inv_diag * r
    return x


def cornered_inv_diag_full(op: CorneredOperator, dtype=None):
    """The full-grid exact 1/diag of a cornered operator (Chebyshev's
    preconditioner; the half-sweeps never form it)."""
    return (1.0 / diag_full(op)).to(dtype or op.dtype)


def _chebyshev_level(op, inv_diag, b, x, iterations):
    """Chebyshev on a level: the exact full inverse diagonal on cornered
    and faced operators, the level's ``inv_diag`` otherwise; λmax and the
    full diagonal computed once per operator (the cycle passes a level's
    own ``inv_diag`` with its operator)."""
    if isinstance(op, (CorneredOperator, FacedStencilOperator)):
        invd = _once(op, "_cheb_inv_diag", lambda: 1.0 / diag_full(op))
    else:
        invd = 1.0 / op.diag() if inv_diag is None else inv_diag
    lam = _once(op, "_cheb_lam_max", lambda: gershgorin_lambda_max(op, invd))
    return chebyshev(op, invd.to(x.dtype), b, x, iterations, lam)


def _faced_fix_half_sweep(op, b, x_old, x_new, mode, omega, color):
    """Rewrite the low-face rows of ``x_new`` (a fresh tensor) with the
    exact half-sweep update from ``x_old``, the iterate before the pass
    (every point of a half-sweep reads the old values, so all faces are
    fixed from the same state; where faces meet they agree)."""

    lead = x_old.ndim - op.ndim

    def plane(fi):
        a = op.face_axes[fi]
        invd = op.face_inv_diag(fi)
        b_f = b.select(lead + a, 0)
        x_f = x_old.select(lead + a, 0)
        if mode == "jacobi":
            return x_f + omega * invd * (b_f - face_apply(op, fi, x_old))
        xn = invd * (b_f - face_apply(op, fi, x_old, exclude_diag=True))
        red = red_mask(x_f.shape[lead:], x_f.device)
        return torch.where(red if color == 0 else ~red, xn, x_f)

    return _fix_faces(op, x_new, plane)


def _smooth_faced(name, op, b, x, iterations, omega):
    """Jacobi or red/black on a faced operator: the constant pass of K3 on
    the whole grid (its plain version on the CPU), then the exact face rows,
    after every pass.  A deeper fusion would carry wrong face values
    inwards, so there is none."""
    from openmg_tpu_torch.ops import kernels

    batch = x.ndim == op.ndim + 1  # a batch: K3b passes on the stack
    for _ in range(iterations):
        if name == "jacobi":
            if batch:
                xn = kernels.half_sweep_batch(op.values, op.offsets, b, x,
                                              "jacobi", omega)
            else:
                xn = kernels.jacobi_const_3d(op.values, op.offsets, b, x, 1, omega)
            x = _faced_fix_half_sweep(op, b, x, xn, "jacobi", omega, 0)
            continue
        for color in (0, 1):
            if batch:
                xn = kernels.half_sweep_batch(op.values, op.offsets, b, x, "rbgs",
                                              0.0, color)
            else:
                xn = kernels.rbgs_half_sweep_const_3d(op.values, op.offsets, b, x,
                                                      color)
            x = _faced_fix_half_sweep(op, b, x, xn, "rb", omega, color)
    return x


def _batch_passes(one, name, b, x, iterations, omega):
    """``iterations`` Jacobi or red/black sweeps of a batch, one batched
    pass (``one(b, x, mode, omega, color)``: K3b or K4b) a Jacobi sweep or
    a colour, as the scalar entry points launch them."""
    for _ in range(iterations):
        if name == "jacobi":
            x = one(b, x, "jacobi", omega, 0)
        else:
            for color in (0, 1):
                x = one(b, x, "rbgs", 0.0, color)
    return x


def _smooth_kernel(name, op, inv_diag, b, x, iterations, omega):
    """``smooth`` through the kernels, or raise: nothing here is plain
    tensor code but Chebyshev's vector updates and a faced operator's face
    rows, which are array code in the JAX package too."""
    from openmg_tpu_torch.ops import fused, kernels

    why = _stencil.kernel_operands_ok(op, x)
    if why is not None:
        raise NotImplementedError(
            f"smooth on {b.device}: {why} is not taken by the smoother "
            "kernels, and plain tensor code does not run on the card"
        )
    if name == "chebyshev":
        return _chebyshev_level(op, inv_diag, b, x, iterations)
    if isinstance(op, FacedStencilOperator):
        return _smooth_faced(name, op, b, x, iterations, omega)
    batch = x.ndim == op.ndim + 1
    if isinstance(op, CorneredOperator) or op.is_constant:
        y = fused.smooth_fused(name, op, b, x, iterations, omega)
        if y is not None:
            return y
        corner = fused._corner_info(op)
        if batch:
            return _batch_passes(
                lambda bb, xx, m, w, c: kernels.half_sweep_batch(
                    op.values, op.offsets, bb, xx, m, w, c, corner),
                name, b, x, iterations, omega,
            )
        if name == "jacobi":
            return kernels.jacobi_const_3d(
                op.values, op.offsets, b, x, iterations, omega, corner=corner
            )
        return kernels.rbgs_const_3d(
            op.values, op.offsets, b, x, iterations, corner=corner
        )
    if batch:
        return _batch_passes(
            lambda bb, xx, m, w, c: kernels.half_sweep_vary_batch(
                op.coeffs, op.offsets, bb, xx, m, w, c),
            name, b, x, iterations, omega,
        )
    if name == "jacobi":
        return kernels.jacobi_vary_3d(op.coeffs, op.offsets, b, x, iterations, omega)
    return kernels.rbgs_vary_3d(op.coeffs, op.offsets, b, x, iterations)


def smooth(name: str, op, inv_diag, b, x, iterations: int, omega: float):
    if iterations <= 0:
        return x
    if name not in ("jacobi", "rbgs", "chebyshev"):
        raise ValueError(f"unknown smoother {name!r}")
    if not _stencil._on_cpu(b):
        return _smooth_kernel(name, op, inv_diag, b, x, iterations, omega)
    if name == "chebyshev":
        return _chebyshev_level(op, inv_diag, b, x, iterations)
    if isinstance(op, FacedStencilOperator):
        return _smooth_faced(name, op, b, x, iterations, omega)
    if name == "jacobi":
        return jacobi(op, inv_diag, b, x, iterations, omega)
    return rbgs(op, inv_diag, b, x, iterations)
