"""Structured (boundary-collapsed) hierarchy setup — exact and O(1)-sized
(twin of ``openmg_tpu/core/structured.py``; host numpy, copied).

Key fact exploited here: for a translation-invariant fine operator with
Dirichlet zero-truncation (Poisson, and any constant :class:`StencilOperator`)
and separable radius-1 transfers, every Galerkin coarse operator is
**boundary-structured**: its coefficient at grid point ``i`` depends only on
each axis coordinate's *category* — the distance from the low boundary (if
close), the distance from the high boundary (if close), or "interior".  The
structure depth is small (≤ 3 observed, ≤ h = 5 budgeted) and closed under
RAP, because a radius-1 RAP step halves distances and adds at most one.

Therefore the entire hierarchy can be computed EXACTLY on tiny dummy grids
(M = 24 per coarsenable axis) with plain numpy, and each real level
materialized by per-axis ``[low rows | broadcast(interior row) | high rows]``
expansion — no big host arrays, no SpGEMM.  Setup cost is then independent
of the grid size apart from the coarsest level's dense inverse.

An internal uniformity assertion validates the depth budget on every run;
the port's tests pin the resulting level tables bit for bit against the JAX
package's.  :func:`expand_rep` materialises a varying level from its
representative on the device (slices, a broadcast and a concatenation: an
exact copy, as the JAX package's traced ``expand_rep``).
"""

from __future__ import annotations

import numpy as np
import torch

from openmg_tpu_torch.ops.galerkin import galerkin_rap_stencil
from openmg_tpu_torch.ops.transfer import Transfer, coarse_shape

__all__ = ["structured_chain", "expand_rep", "expand_rep_np", "StructuredLevel"]

M = 24  # dummy extent per collapsed axis (must be even; depth budget h=M//2-1 after halving)


class StructuredLevel:
    """One level of the boundary-collapsed chain.

    rep: numpy ``(K, *m_shape)`` representative coefficient array; axes with
        ``m < n`` are collapsed (low ``h`` rows | interior at index ``h`` |
        high ``h`` rows), axes with ``m == n`` are exact.
    """

    def __init__(self, offsets, rep, real_shape):
        self.offsets = tuple(tuple(o) for o in offsets)
        self.rep = rep
        self.real_shape = tuple(int(s) for s in real_shape)
        self.m_shape = tuple(rep.shape[1:])

    def h(self, axis) -> int:
        return self.m_shape[axis] // 2 - 1

    @property
    def collapsed_axes(self):
        return [
            a for a, (m, n) in enumerate(zip(self.m_shape, self.real_shape))
            if m < n
        ]

    def nnz(self) -> int:
        """Exact nonzero count of the expanded level, via per-axis
        expansion multiplicities."""
        total = 0
        K = self.rep.shape[0]
        nz = self.rep != 0
        mults = []
        for a, (m, n) in enumerate(zip(self.m_shape, self.real_shape)):
            mult = np.ones(m, dtype=np.int64)
            if m < n:
                h = self.h(a)
                mult[:] = 0
                mult[:h] = 1
                mult[m - h:] = 1
                mult[h] = n - 2 * h
            mults.append(mult)
        w = nz.astype(np.int64)
        for a, mult in enumerate(mults):
            view = [1] * (w.ndim)
            view[a + 1] = -1
            w = w * mult.reshape(view)
        return int(w.sum())


def _collapse_axis(rep, axis, n_next):
    """After a RAP halving, re-validate and (if the real extent stays above
    the dummy size) re-expand the dummy axis back to M."""
    m = rep.shape[axis + 1]
    h = m // 2 - 1
    # uniformity check: the middle region [h, m-h) must be constant along
    # this axis — this *proves* the depth budget holds for this operator
    mid = rep.take(range(h, m - h), axis=axis + 1)
    first = rep.take([h], axis=axis + 1)
    if not np.array_equal(mid, np.broadcast_to(first, mid.shape)):
        raise ValueError(
            "operator is not boundary-structured within the depth budget; "
            "use the direct setup path"
        )
    target = min(M, n_next)  # exact when the real extent fits, else stay collapsed
    if target == m:
        return rep
    return expand_rep_np(rep, axis, target)


def expand_rep_np(rep, axis, n):
    """numpy expansion of one collapsed axis to extent ``n``:
    ``[low h rows | (n-2h) copies of row h | high h rows]``."""
    m = rep.shape[axis + 1]
    h = m // 2 - 1
    if n == m:
        return rep
    if n < 2 * h + 1:
        raise ValueError(f"cannot expand collapsed axis {axis} (m={m}) to {n}")
    lo = rep.take(range(h), axis=axis + 1)
    midrow = rep.take([h], axis=axis + 1)
    mid = np.broadcast_to(
        midrow, midrow.shape[: axis + 1] + (n - 2 * h,) + midrow.shape[axis + 2:]
    )
    hi = rep.take(range(m - h, m), axis=axis + 1)
    return np.concatenate([lo, mid, hi], axis=axis + 1)


def expand_rep(rep: torch.Tensor, m_shape, real_shape) -> torch.Tensor:
    """Tensor expansion of every collapsed axis of ``rep`` (``(K, *m_shape)``,
    on any device) to ``real_shape``, as :func:`expand_rep_np` does one axis:
    the result is contiguous and holds copies of the representative's
    values only."""
    out = rep
    for a, (m, n) in enumerate(zip(m_shape, real_shape)):
        if m == n:
            continue
        h = m // 2 - 1
        if n < 2 * h + 1:
            raise ValueError(f"cannot expand collapsed axis {a} (m={m}) to {n}")
        axis = a + 1
        mid = out.narrow(axis, h, 1)
        size = list(out.shape)
        size[axis] = n - 2 * h
        out = torch.cat(
            [out.narrow(axis, 0, h), mid.expand(size), out.narrow(axis, m - h, h)],
            dim=axis,
        )
    return out.contiguous()


def structured_chain(
    offsets, fine_values, shape, gridlevels: int, transfer: Transfer
):
    """Compute the full exact hierarchy in boundary-collapsed form.

    ``fine_values``: the (K,) constant fine stencil values (e.g. Poisson).
    Returns a list of :class:`StructuredLevel` (finest first).  All numpy,
    all tiny (each rep is at most ``K × 24^d``).
    """
    shape = tuple(int(s) for s in shape)
    offsets = tuple(tuple(o) for o in offsets)
    vals = np.asarray(fine_values, dtype=np.float64)

    def rep_shape_for(real):
        return tuple(min(n, M) if n > 1 else 1 for n in real)

    # level 0: materialize the constant fine stencil on the dummy grid
    m_shape = rep_shape_for(shape)
    K = len(offsets)
    rep = np.zeros((K,) + m_shape)
    for k, off in enumerate(offsets):
        sl = tuple(
            slice(max(0, -o), m - max(0, o)) for o, m in zip(off, m_shape)
        )
        rep[(k,) + sl] = vals[k]
    levels = [StructuredLevel(offsets, rep, shape)]

    real = shape
    for _ in range(int(gridlevels) - 1):
        lvl = levels[-1]
        c_offs, c_rep = galerkin_rap_stencil(
            lvl.offsets, lvl.rep, transfer=transfer
        )
        real = coarse_shape(real)
        # per axis: exact if the dummy axis was exact; else re-validate and
        # re-expand the halved dummy axis
        out = c_rep
        for a in range(len(real)):
            m_prev = lvl.m_shape[a]
            n_prev = lvl.real_shape[a]
            if m_prev == n_prev:
                continue  # axis was exact; RAP result is exact
            out = _collapse_axis(out, a, real[a])
        levels.append(StructuredLevel(c_offs, out, real))
    return levels
