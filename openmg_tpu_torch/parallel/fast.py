"""The kernel tier on row-partitioned levels (twin of
``openmg_tpu/parallel/fast.py``).

A partitioned level's passes and visits run through the halo forms of the
stencil kernels, which read the received planes at the slab's z edges
inside the kernel:

* a pass (Jacobi, one red/black colour, or the residual) of a constant or
  cornered level is one launch of K3's halo form, and of a varying level
  one launch of K4's, with the one-plane halos of :func:`halo_planes`;
* a level visit of a constant or cornered 3D level (pre-smoothing with the
  residual and its restriction, the prolongation with post-smoothing, the
  residual with its restriction, or chunks of smoothing stages) is one
  launch of K1's halo form, with D-deep halo slabs of ``b`` and ``x`` (and
  of the coarse correction);
* a cornered level needs no fix-up pass: the kernels pick a point's tap
  row from the region table, and the regions on axis 0, which lie at the
  global plane 0, are kept on the first rank only (``open_lo``).

A 2D slab ``(ny, nx)`` partitioned along y runs the passes as the 3D slab
``(ny, 1, nx)``, whose z axis is the partition axis, so its received rows
are planes the kernels read in place (the JAX package corrects the two
boundary rows of a zero-halo pass afterwards instead; the port has no such
epilogue).  The fused visits take 3D slabs only, as in the JAX package.

Every function takes the partition axis as a
:class:`~openmg_tpu_torch.parallel.halo.Comm` and returns None where its
tier does not take the case (the caller then takes the next tier down).
"""

from __future__ import annotations

import torch

from openmg_tpu_torch.ops import fused, kernels
from openmg_tpu_torch.ops.smoothers import gershgorin_lambda_max
from openmg_tpu_torch.ops.stencil import CorneredOperator, StencilOperator, diag_index
from openmg_tpu_torch.parallel.halo import halo_planes, open_flags

__all__ = [
    "is_fast_op",
    "smooth_part",
    "residual_part",
    "smooth_part_vary",
    "residual_part_vary",
    "smooth_chunks_part",
    "presmooth_restrict_part",
    "prolong_smooth_part",
    "residual_restrict_part",
]

_KMODE = {"jacobi": "jacobi", "rb": "rbgs", "residual": "residual"}


def is_fast_op(op) -> bool:
    """Does the partitioned kernel tier take this operator's passes?"""
    return isinstance(op, CorneredOperator) or (
        isinstance(op, StencilOperator) and op.is_constant
    )


def _pass(op, b, x, mode, omega, color, comm):
    """One constant or cornered pass on the slab: K3's halo form."""
    lower, upper = halo_planes(x, comm)
    return kernels.halo_half_sweep_const_3d(
        op.values, op.offsets, b, x, _KMODE[mode], omega, color, lower, upper,
        corner=fused._corner_info(op), open_lo=open_flags(comm)[0],
    )


def residual_part(op, b, x, comm):
    """``r = b − A x`` on the slab of a partitioned constant or cornered
    level: one launch of K3's halo form."""
    return _pass(op, b, x, "residual", 0.0, 0, comm)


def _inv_diag_part(op, shape, comm):
    """The exact 1/diag on the slab of a partitioned cornered level
    (Chebyshev's preconditioner): the interior value, with the region rows
    of the slab (axis-0 regions on the first rank only)."""
    di = diag_index(op.offsets)
    invd = torch.full(shape, 1.0, dtype=op.dtype, device=op.device) / op.values[di]
    corner = fused.gate_corner(fused._corner_info(op), open_flags(comm)[0])
    if corner:
        regions, table = corner
        for r, R in enumerate(regions):
            idx = tuple(slice(0, 1) if a in R else slice(None) for a in range(len(shape)))
            invd[idx] = 1.0 / table[r, di]
    return invd


def _chebyshev(op, invd, lam, b, x, iterations, residual):
    """4th-kind Chebyshev on the slab, each residual ``residual(b, x)``."""
    r = residual(b, x)
    d = (4.0 / 3.0) / lam * invd * r
    for k in range(1, iterations + 1):
        x = x + d
        if k == iterations:
            break
        r = residual(r, d)  # r ← r − A d
        d = ((2 * k - 1) / (2 * k + 3)) * d + (
            (8 * k + 4) / (2 * k + 3)
        ) / lam * invd * r
    return x


def _sweeps(name):
    if name == "jacobi":
        return (("jacobi", 0),)
    if name == "rbgs":
        return (("rb", 0), ("rb", 1))
    raise ValueError(f"unknown smoother {name!r}")


def smooth_part(name, op, b, x, iterations, omega, comm):
    """Smoothing on the slab of a partitioned constant or cornered level, a
    pass a launch (K3's halo form), each pass after its own exchange."""
    if iterations <= 0:
        return x
    if name == "chebyshev":
        di = diag_index(op.offsets)
        invd = (
            _inv_diag_part(op, tuple(x.shape), comm)
            if isinstance(op, CorneredOperator) else 1.0 / op.values[di]
        )
        lam = gershgorin_lambda_max(op, 1.0 / op.values[di]).to(x.dtype)
        return _chebyshev(
            op, invd, lam, b, x, iterations,
            lambda bb, xx: residual_part(op, bb, xx, comm),
        )
    for _ in range(iterations):
        for mode, color in _sweeps(name):
            x = _pass(op, b, x, mode, omega, color, comm)
    return x


def _pass_vary(op, b, x, mode, omega, color, comm):
    lower, upper = halo_planes(x, comm)
    return kernels.halo_half_sweep_vary_3d(
        op.coeffs, op.offsets, b, x, _KMODE[mode], omega, color, lower, upper
    )


def residual_part_vary(op, b, x, comm):
    """``r = b − A x`` on the slab of a partitioned varying level: one
    launch of K4's halo form."""
    return _pass_vary(op, b, x, "residual", 0.0, 0, comm)


def smooth_part_vary(name, op, inv_diag, b, x, iterations, omega, comm):
    """Smoothing on the slab of a partitioned varying level, a pass a
    launch of K4's halo form.  Chebyshev takes the largest Gershgorin
    bound of the ranks (one polynomial everywhere)."""
    if iterations <= 0:
        return x
    if name == "chebyshev":
        lam = comm.all_max(gershgorin_lambda_max(op, inv_diag)).to(x.dtype)
        return _chebyshev(
            op, inv_diag, lam, b, x, iterations,
            lambda bb, xx: residual_part_vary(op, bb, xx, comm),
        )
    for _ in range(iterations):
        for mode, color in _sweeps(name):
            x = _pass_vary(op, b, x, mode, omega, color, comm)
    return x


# ---------------------------------------------------------------------------
# level visits on partitioned levels: K1's halo form
# ---------------------------------------------------------------------------


def _fusable(op, b) -> bool:
    return (
        b.ndim == 3 and b.dtype == torch.float32 and is_fast_op(op)
        and len(op.offsets) <= 27
        and all(abs(o) <= 1 for off in op.offsets for o in off)
    )


def _halos(comm, b, x, depth, ec=None):
    """K1's ``halos`` argument: the flags and the depth-deep slabs of ``b``
    (and ``x``; and of ``ec``, ``depth // 2`` below and ``depth // 2 + 1``
    above), all in one exchange."""
    items = [(b, depth, depth)]
    if x is not None:
        items.append((x, depth, depth))
    if ec is not None:
        items.append((ec, depth // 2, depth // 2 + 1))
    got = comm.exchange(items)
    x_pair = got[1] if x is not None else None
    ec_pair = got[-1] if ec is not None else None
    return open_flags(comm), got[0], x_pair, ec_pair


def smooth_chunks_part(name, op, b, x, iterations, omega, comm):
    """Smoothing stages in chunks of up to ``MAX_DEPTH``, each chunk one
    launch of K1's halo form with chunk-deep slabs (``b``'s exchanged once
    at the widest chunk, ``x``'s before each chunk).  Returns the smoothed
    ``x`` or None where the tier does not take the case."""
    if not _fusable(op, b):
        return None
    stages = fused.stages_for(name, iterations, omega)
    if not stages or len(stages) < 2:
        return None
    c_max = min(len(stages), fused.MAX_DEPTH, b.shape[0])
    if c_max < 2:
        return None
    flags = open_flags(comm)
    b_lo, b_hi = comm.exchange([(b, c_max, c_max)])[0]
    rest = list(stages)
    while rest:
        c = min(c_max, len(rest))
        chunk, rest = rest[:c], rest[c:]
        # the b slabs of a shorter chunk: the neighbours' last / first c
        b_pair = (b_lo[c_max - c:], b_hi[:c])
        x_pair = comm.exchange([(x, c, c)])[0]
        x = fused.fused_stages_const_3d(
            op.values, op.offsets, b, x, chunk, corner=fused._corner_info(op),
            halos=(flags, b_pair, x_pair, None),
        )
    return x


def presmooth_restrict_part(name, op, b, x, iterations, omega, transfer, comm):
    """Pre-smoothing (from zero, or from ``x``), the residual and its
    restriction on the slab: one launch of K1's halo form, the fine
    residual never stored.  Both this level and the next are partitioned
    (the coarse slab is the rank's: slabs are even).  Returns ``(x,
    bc_local)`` or None."""
    if not _fusable(op, b) or not fused._transfer_ok(b.shape, transfer):
        return None
    stages = fused.stages_for(name, iterations, omega)
    if not stages:
        return None
    depth = fused.halo_depth(len(stages), True, True, False)
    if depth > fused.MAX_DEPTH or depth > b.shape[0]:
        return None
    return fused.presmooth_restrict_fused(
        name, op, b, x, iterations, omega, transfer,
        halos=_halos(comm, b, x, depth),
    )


def prolong_smooth_part(name, op, b, x, ec, iterations, omega, transfer, comm):
    """``x + P ec`` and the post-smoothing on the slab: one launch of K1's
    halo form (slabs of ``b``, ``x`` and the coarse ``ec``).  Returns the
    smoothed ``x`` or None."""
    if not _fusable(op, b) or not fused._transfer_ok(b.shape, transfer):
        return None
    stages = fused.stages_for(name, iterations, omega)
    if stages is None:
        return None
    depth = fused.halo_depth(len(stages), False, False, True)
    if (len(stages) > fused.MAX_DEPTH or depth > b.shape[0]
            or depth // 2 + 1 > ec.shape[0]):
        return None
    return fused.prolong_smooth_fused(
        name, op, b, x, ec, iterations, omega, transfer,
        halos=_halos(comm, b, x, depth, ec),
    )


def residual_restrict_part(op, b, x, transfer, comm):
    """The residual and its restriction on the slab, no stages: one launch
    of K1's halo form (two-deep slabs of ``b`` and ``x``).  Returns the
    coarse slab ``bc`` or None."""
    if not _fusable(op, b) or not fused._transfer_ok(b.shape, transfer):
        return None
    depth = fused.halo_depth(0, True, True, False)
    if depth > b.shape[0]:
        return None
    return fused.residual_restrict_fused(
        op, b, x, transfer, halos=_halos(comm, b, x, depth)
    )
