"""Grid transfer operators: restriction / prolongation (twin of
``openmg_tpu/ops/transfer.py``).

Transfers are *separable*: a per-axis tap list ``(offset t, weight w)``
defines ``R_axis[c, f] = Σ_t w·[f = 2c + t]`` and analogously for P; the
d-dimensional operator is the tensor product over coarsened axes.  Two
specs ship:

* ``AGGREGATE`` — piecewise-constant aggregation over each coarse point's
  ``2^d`` fine children (the original algorithm's scheme).
* ``LINEAR`` — vertex-centred full-weighting restriction with linear
  interpolation (taps at ``t ∈ {−1, 0, 1}`` around ``f = 2c``; R = Pᵀ/2
  per dim).  Its {−1,0,1} support keeps Galerkin coarse stencils at ≤ 3^d
  points.

Out-of-domain taps are zero-filled (no boundary renormalisation), the
Dirichlet-consistent choice that keeps R = c·Pᵀ exact.  Dims of size 1 are
never coarsened.

A batch ``(K, *grid)`` (``solve_many``) keeps its leading axis, which is
never coarsened: ``restrict`` is told the grid's dimension, ``prolong``
reads it from ``fine_shape``.  The transfers are elementwise, so each
member has the bits of the scalar call on it.

Only the strided-slice form is ported: on grid-shaped tensors the products
are parity slices and interleaves.  (The JAX package's tap-matrix matmul
form exists for its own hardware's layout rules and is not copied.)  On
constant and cornered levels these functions are not called on the card at
all: the fused kernel of :mod:`openmg_tpu_torch.ops.fused` applies the same
taps itself.  On varying levels the V-cycle calls them on any device, as
the JAX package runs them as array code outside any kernel there.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

__all__ = [
    "Transfer",
    "AGGREGATE",
    "LINEAR",
    "TRANSFERS",
    "coarse_shape",
    "restrict",
    "prolong",
]


@dataclasses.dataclass(frozen=True)
class Transfer:
    """Separable transfer spec: per-axis restriction/prolongation taps.

    Each tap list is a tuple of ``(t, w)``: ``R[c, f] = Σ w·[f = 2c + t]``
    per coarsened axis (tensor product across axes); similarly
    ``P[f, c] = Σ w·[f = 2c + t]`` using ``p_taps``.
    """

    name: str
    r_taps: tuple
    p_taps: tuple


AGGREGATE = Transfer(
    name="aggregate",
    r_taps=((0, 0.5), (1, 0.5)),
    p_taps=((0, 0.5), (1, 0.5)),
)

LINEAR = Transfer(
    name="linear",
    r_taps=((-1, 0.25), (0, 0.5), (1, 0.25)),
    p_taps=((-1, 0.5), (0, 1.0), (1, 0.5)),
)

TRANSFERS = {t.name: t for t in (AGGREGATE, LINEAR)}


def coarse_shape(shape) -> tuple:
    return tuple(max(1, int(s) // 2) for s in shape)


def _coarsened_axes(shape):
    return [a for a, s in enumerate(shape) if s > 1]


def _shift_axis(x: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """``z[i] = x[i + s]`` along one axis, zero-filled (static shift)."""
    if s == 0:
        return x
    n = x.shape[axis]
    pad = [0, 0] * x.ndim
    # F.pad lists the last dim first: entry 2·(ndim−1−axis) is the low side
    j = 2 * (x.ndim - 1 - axis)
    pad[j], pad[j + 1] = max(0, -s), max(0, s)
    return F.pad(x, pad).narrow(axis, max(0, s), n)


def _parity_slice(x: torch.Tensor, pm: int, axis: int) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(pm, None, 2)
    return x[tuple(idx)]


def _restrict_axis(v, axis: int, taps):
    """out[I] = Σ_t w(t) · v[2I + t] along ``axis`` (zero-fill OOB)."""
    out = None
    for t, w in taps:
        pm = t % 2  # Python mod: −1 % 2 == 1
        s = (t - pm) // 2
        samp = _shift_axis(_parity_slice(v, pm, axis), s, axis)
        term = samp * w
        out = term if out is None else out + term
    return out


def _prolong_axis(u, axis: int, taps):
    """out[2I + pm] = Σ_{t ≡ pm (2)} w(t) · u[I − (t − pm)/2] along axis."""
    parts = []
    for pm in (0, 1):
        part = None
        for t, w in taps:
            if t % 2 != pm:
                continue
            s = (t - pm) // 2
            term = _shift_axis(u, -s, axis) * w
            part = term if part is None else part + term
        parts.append(part)
    # interleave even/odd fine positions along `axis`
    stacked = torch.stack(parts, dim=axis + 1)
    new_shape = list(u.shape)
    new_shape[axis] = u.shape[axis] * 2
    return stacked.reshape(new_shape)


def restrict(v: torch.Tensor, transfer: Transfer = AGGREGATE,
             ndim: int | None = None) -> torch.Tensor:
    """``R v`` (fine → coarse), separably over all coarsenable axes.
    ``ndim``: the grid's dimension, when ``v`` is a batch ``(K, *grid)``
    (its leading axis is kept); None: ``v`` is one grid."""
    lead = 0 if ndim is None else v.ndim - ndim
    out = v
    for a in _coarsened_axes(v.shape[lead:]):
        out = _restrict_axis(out, lead + a, transfer.r_taps)
    return out


def prolong(u: torch.Tensor, fine_shape, transfer: Transfer = AGGREGATE):
    """``P u`` (coarse → fine).

    ``fine_shape`` identifies which axes were coarsened (those with
    ``fine == 2 * coarse``); a coarse dim of 1 that came from a fine dim of
    2 must still be expanded, so the fine shape cannot be inferred from
    ``u`` alone.  A ``u`` with more axes than ``fine_shape`` is a batch:
    its leading axes are kept.
    """
    lead = u.ndim - len(fine_shape)
    grid = u.shape[lead:]
    axes = [a for a, (f, c) in enumerate(zip(fine_shape, grid)) if f == 2 * c]
    for a, (f, c) in enumerate(zip(fine_shape, grid)):
        if a not in axes and f != c:
            raise ValueError(
                f"incompatible shapes {tuple(u.shape)} -> {tuple(fine_shape)}"
            )
    out = u
    for a in axes:
        out = _prolong_axis(out, lead + a, transfer.p_taps)
    return out
