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

**A stack of members** (``solve_many``): every function takes ``b`` and
``x`` as a ``(K, *slab)`` stack too, decided by the operator's dimension
(the tensor has one axis more), and then runs each launch in its halo form
on a batch (K3hb, K4hb, K1hb) after one exchange of the stack's planes
(partition axis 1).  A member runs the scalar plan: the predicates below
read the slab's shape, never the stack's.  λmax and the 1/diag of
Chebyshev stay one per operator; its updates are tensor code on the stack.

Every function takes the partition axis as a
:class:`~openmg_tpu_torch.parallel.halo.Comm`.  Whether K1h takes a visit,
and at which halo depth, is a static function of the slab's shape, the
operator and the config: the ``*_depth`` and :func:`chunk_sizes` predicates
say it, the distributed solver evaluates them once a level
(:attr:`~openmg_tpu_torch.parallel.dist.DistributedSolver.visits`), and its
cycle and the communication model (:mod:`openmg_tpu_torch.parallel.model`)
both read that plan.  A visit function takes the depth the plan gives it.
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
    "chunk_sizes",
    "presmooth_depth",
    "prolong_depth",
    "residual_restrict_depth",
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


def _axis(op, t) -> int:
    """The partition axis of ``t``: 1 for a stack of ``op``'s slabs (one
    axis more than the operator), else 0."""
    return int(t.ndim == op.ndim + 1)


def _pass(op, b, x, mode, omega, color, comm):
    """One constant or cornered pass on the slab: K3's halo form (K3hb on
    a stack)."""
    axis = _axis(op, x)
    lower, upper = halo_planes(x, comm, axis)
    run = kernels.halo_half_sweep_batch if axis else kernels.halo_half_sweep_const_3d
    return run(
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
            _inv_diag_part(op, tuple(x.shape[_axis(op, x):]), comm)
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
    axis = _axis(op, x)
    lower, upper = halo_planes(x, comm, axis)
    run = kernels.halo_half_sweep_vary_batch if axis else kernels.halo_half_sweep_vary_3d
    return run(op.coeffs, op.offsets, b, x, _KMODE[mode], omega, color, lower, upper)


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


def _fusable(op, shape, dtype) -> bool:
    return (
        len(shape) == 3 and dtype == torch.float32 and is_fast_op(op)
        and len(op.offsets) <= 27
        and all(abs(o) <= 1 for off in op.offsets for o in off)
    )


def chunk_sizes(name, op, shape, dtype, iterations, omega):
    """The K1h launches that smooth ``iterations`` on a slab of ``shape``:
    their chunk lengths (the first the widest), or None where smoothing
    runs a pass a launch."""
    if not _fusable(op, shape, dtype):
        return None
    stages = fused.stages_for(name, iterations, omega)
    if not stages or len(stages) < 2:
        return None
    c_max = min(len(stages), fused.MAX_DEPTH, shape[0])
    if c_max < 2:
        return None
    sizes, rest = [], len(stages)
    while rest:
        sizes.append(min(c_max, rest))
        rest -= sizes[-1]
    return tuple(sizes)


def presmooth_depth(name, op, shape, dtype, iterations, omega, transfer):
    """The halo depth of K1h's pre-smoothing + residual + restriction visit
    on a slab of ``shape``, or None where the tier does not take it."""
    if not _fusable(op, shape, dtype) or not fused._transfer_ok(shape, transfer):
        return None
    stages = fused.stages_for(name, iterations, omega)
    if not stages:
        return None
    depth = fused.halo_depth(len(stages), True, True, False)
    return depth if depth <= fused.MAX_DEPTH and depth <= shape[0] else None


def prolong_depth(name, op, shape, coarse_rows, dtype, iterations, omega, transfer):
    """The halo depth of K1h's ``x + P ec`` + post-smoothing visit on a slab
    of ``shape`` over a coarse slab of ``coarse_rows`` planes, or None."""
    if not _fusable(op, shape, dtype) or not fused._transfer_ok(shape, transfer):
        return None
    stages = fused.stages_for(name, iterations, omega)
    if stages is None:
        return None
    depth = fused.halo_depth(len(stages), False, False, True)
    if len(stages) > fused.MAX_DEPTH or depth > shape[0] or depth // 2 + 1 > coarse_rows:
        return None
    return depth


def residual_restrict_depth(op, shape, dtype, transfer):
    """The halo depth of K1h's residual + restriction visit (no stages), or
    None."""
    if not _fusable(op, shape, dtype) or not fused._transfer_ok(shape, transfer):
        return None
    depth = fused.halo_depth(0, True, True, False)
    return depth if depth <= shape[0] else None


def _halos(comm, op, b, x, depth, ec=None):
    """K1's ``halos`` argument: the flags and the depth-deep slabs of ``b``
    (and ``x``; and of ``ec``, ``depth // 2`` below and ``depth // 2 + 1``
    above), all in one exchange (of the whole stack for a stack)."""
    items = [(b, depth, depth)]
    if x is not None:
        items.append((x, depth, depth))
    if ec is not None:
        items.append((ec, depth // 2, depth // 2 + 1))
    got = comm.exchange(items, _axis(op, b))
    x_pair = got[1] if x is not None else None
    ec_pair = got[-1] if ec is not None else None
    return open_flags(comm), got[0], x_pair, ec_pair


def smooth_chunks_part(name, op, b, x, iterations, omega, comm, sizes):
    """Smoothing stages in the chunks of :func:`chunk_sizes`, each chunk one
    launch of K1's halo form with chunk-deep slabs (``b``'s exchanged once
    at the widest chunk, ``x``'s before each chunk)."""
    stages = fused.stages_for(name, iterations, omega)
    c_max = sizes[0]
    flags = open_flags(comm)
    axis = _axis(op, b)
    b_lo, b_hi = comm.exchange([(b, c_max, c_max)], axis)[0]
    visit = fused.fused_stages_const_3d_batch if axis else fused.fused_stages_const_3d
    rest = list(stages)
    for c in sizes:
        chunk, rest = rest[:c], rest[c:]
        # the b slabs of a shorter chunk: the neighbours' last / first c
        b_pair = (b_lo.narrow(axis, c_max - c, c).contiguous(),
                  b_hi.narrow(axis, 0, c).contiguous())
        x_pair = comm.exchange([(x, c, c)], axis)[0]
        x = visit(
            op.values, op.offsets, b, x, chunk, corner=fused._corner_info(op),
            halos=(flags, b_pair, x_pair, None),
        )
    return x


def presmooth_restrict_part(name, op, b, x, iterations, omega, transfer, comm, depth):
    """Pre-smoothing (from zero, or from ``x``), the residual and its
    restriction on the slab: one launch of K1's halo form at the halo depth
    of :func:`presmooth_depth`, the fine residual never stored.  Both this
    level and the next are partitioned (the coarse slab is the rank's:
    slabs are even).  Returns ``(x, bc_local)``."""
    return fused.presmooth_restrict_fused(
        name, op, b, x, iterations, omega, transfer,
        halos=_halos(comm, op, b, x, depth),
    )


def prolong_smooth_part(name, op, b, x, ec, iterations, omega, transfer, comm, depth):
    """``x + P ec`` and the post-smoothing on the slab: one launch of K1's
    halo form (slabs of ``b``, ``x`` and the coarse ``ec``) at the depth of
    :func:`prolong_depth`.  Returns the smoothed ``x``."""
    return fused.prolong_smooth_fused(
        name, op, b, x, ec, iterations, omega, transfer,
        halos=_halos(comm, op, b, x, depth, ec),
    )


def residual_restrict_part(op, b, x, transfer, comm, depth):
    """The residual and its restriction on the slab, no stages: one launch
    of K1's halo form (slabs of ``b`` and ``x`` at the depth of
    :func:`residual_restrict_depth`).  Returns the coarse slab ``bc``."""
    return fused.residual_restrict_fused(
        op, b, x, transfer, halos=_halos(comm, op, b, x, depth)
    )
