"""Stencil (DIA-on-grid) operators (twin of ``openmg_tpu/ops/stencil.py``).

Every matrix whose rows/columns live on a regular grid and whose couplings
use a bounded set of multi-index offsets is stored per static offset
``offsets[k]``; SpMV is shift–multiply–add over dense grid tensors: no
gather, no index traffic.

Ported here: :class:`StencilOperator` (constant and varying storage),
:class:`CorneredOperator` (the O(K) exact form of the linear-transfer
Galerkin levels), :class:`FacedStencilOperator` (the JAX package's legacy
form of the same levels: constant taps and dense low-face planes),
``region_table``, ``diag_index``, ``shift``, ``face_apply``, ``apply`` and
``residual``.  ``apply`` and ``face_apply`` are plain tensor code on any
device, as they are array code outside any kernel in the JAX package.
``residual`` dispatches on the device of ``b``: CPU tensors take the plain
tensor code below; CUDA float32 operands of a radius-1 3D (or lifted 1D or
2D) operator go to the per-pass kernel of
:mod:`openmg_tpu_torch.ops.kernels` (constant and cornered taps, or
per-point coefficient grids; a cornered 1D or 2D operator lifts its region
table too); a faced operator takes the constant pass on the whole grid and
then its face planes in tensor code, as in the JAX package; any other case
on the card raises.

**A batch** ``(K, *grid)`` of grids (``solve_many``): ``shift``, ``apply``,
``face_apply`` and ``residual`` take one where the tensor has one axis more
than the operator's grid (the operator's dimension decides, never the
tensor's alone).  The tensor code runs on the whole stack, elementwise, so
each member has the bits of the scalar call on it; on the card
``residual`` is one launch of the batched per-pass kernel (K3b, K4b) for
the stack.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "StencilOperator",
    "CorneredOperator",
    "FacedStencilOperator",
    "face_apply",
    "shift",
    "apply",
    "residual",
    "kernel_operands_ok",
    "kernel_taps_ok",
    "diag_index",
    "region_table",
]


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Sparse operator in DIA-on-grid form.

    Two storage modes:

    * **varying** (general): ``coeffs`` is ``(K, *grid_shape)`` with
      ``coeffs[k][i] = A[i, i + offsets[k]]``, zero where the neighbour
      leaves the grid; ``values is None``.
    * **constant**: ``coeffs is None`` and ``values`` is a ``(K,)`` vector —
      the operator is translation-invariant with Dirichlet (zero)
      truncation at the grid boundary, i.e. ``A[i, i+o_k] = values[k]``
      whenever ``i + o_k`` is in the grid.  SpMV then reads only ``x``.

    offsets: static tuple of K integer d-tuples.
    shape: static grid shape (required in constant mode).
    """

    coeffs: torch.Tensor | None
    offsets: tuple
    values: torch.Tensor | None = None
    shape: tuple | None = None

    @property
    def is_constant(self) -> bool:
        return self.coeffs is None

    @property
    def grid_shape(self) -> tuple:
        if self.coeffs is not None:
            return tuple(self.coeffs.shape[1:])
        return tuple(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def n(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.coeffs.dtype if self.coeffs is not None else self.values.dtype

    @property
    def device(self):
        return self.coeffs.device if self.coeffs is not None else self.values.device

    def coeff(self, k: int):
        """The k-th coefficient (grid tensor or 0-d tensor)."""
        return self.coeffs[k] if self.coeffs is not None else self.values[k]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)

    def diag(self):
        return self.coeff(diag_index(self.offsets))

    def astype(self, dtype) -> "StencilOperator":
        if self.coeffs is not None:
            return StencilOperator(self.coeffs.to(dtype), self.offsets)
        return StencilOperator(
            None, self.offsets, self.values.to(dtype), self.shape
        )


@dataclasses.dataclass(frozen=True)
class CorneredOperator:
    """Corner-collapsed boundary-corrected constant stencil — the compact
    exact form of Galerkin coarsenings of constant Dirichlet-truncated
    operators under separable radius-1 transfers.

    For those operators **the tap value at row ``i`` for offset ``o``
    depends only on the set of axes ``{b : i_b == 0 and o_b == 0}``** (every
    1D transfer/operator factor is Toeplitz except its ``[0, 0]`` entry).
    Storage is O(K): the interior taps ``values`` plus one ``(K,)``
    deviation row per nonempty axis subset ``S`` (inclusion–exclusion form,
    rows stacked into one ``(n_subsets, K)`` tensor) —

        tap(i, k) = values[k] + Σ_{S ∈ subsets, S ⊆ Z(i) ∩ Z(o_k)} deltas[S][k]

    with ``Z(i) = {b : i_b = 0}`` and ``Z(o) = {b : o_b = 0}``.  The whole
    table is at most 8 rows of 27 floats, which is what lets one kernel
    thread pick its row of taps from three comparisons.
    """

    values: torch.Tensor  # (K,) interior taps
    deltas: torch.Tensor  # (n_subsets, K) deviation rows, aligned with subsets
    offsets: tuple
    shape: tuple
    subsets: tuple  # static nonempty axis subsets (tuples), ascending |S|

    @property
    def is_constant(self) -> bool:
        return False

    @property
    def is_cornered(self) -> bool:
        return True

    @property
    def grid_shape(self) -> tuple:
        return tuple(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def face_axes(self) -> tuple:
        """Axes carrying any boundary deviation (union of the subsets)."""
        return tuple(sorted({b for S in self.subsets for b in S}))

    @property
    def regions(self) -> tuple:
        """All nonempty subsets of ``face_axes``, ascending |S|.  A row
        whose zero coordinates (within ``face_axes``) are exactly ``R`` uses
        the region-table row of ``R``; written in this order, deeper regions
        overwrite shallower ones."""
        axes = self.face_axes
        out = []
        for size in range(1, len(axes) + 1):
            out.extend(tuple(c) for c in itertools.combinations(axes, size))
        return tuple(out)

    @property
    def const_op(self) -> StencilOperator:
        """The interior constant stencil as a plain operator."""
        return StencilOperator(None, self.offsets, self.values, self.shape)

    @functools.cached_property
    def table(self) -> torch.Tensor:
        """:func:`region_table` of this operator, computed once (the
        instance is immutable, so the table cannot go stale)."""
        return region_table(self)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)

    def astype(self, dtype) -> "CorneredOperator":
        return dataclasses.replace(
            self, values=self.values.to(dtype), deltas=self.deltas.to(dtype)
        )

    def to_varying(self) -> StencilOperator:
        """Materialize the full ``(K, *grid)`` coefficient tensor."""
        tbl = self.table
        ks = []
        for k, off in enumerate(self.offsets):
            tap = torch.full(
                self.shape, 0.0, dtype=self.dtype, device=self.device
            ) + self.values[k]
            for r, R in enumerate(self.regions):
                if not all(off[b] == 0 for b in R):
                    continue
                idx = tuple(
                    slice(0, 1) if b in R else slice(None)
                    for b in range(len(self.shape))
                )
                tap[idx] = tbl[r, k]
            for axis, o in enumerate(off):
                if o == 0:
                    continue
                idx = [slice(None)] * len(self.shape)
                n = self.shape[axis]
                idx[axis] = slice(max(0, n - o), n) if o > 0 else slice(0, min(n, -o))
                tap[tuple(idx)] = 0
            ks.append(tap)
        return StencilOperator(torch.stack(ks), self.offsets)


def _in_domain_mask(off, shape, device):
    """Boolean grid, True where ``i + off`` stays in the grid; None when
    every row does (the zero offset)."""
    mask = None
    for axis, o in enumerate(off):
        if o == 0:
            continue
        view = [1] * len(shape)
        view[axis] = -1
        i = torch.arange(shape[axis], device=device).reshape(view)
        cond = i < shape[axis] - o if o > 0 else i >= -o
        mask = cond if mask is None else mask & cond
    return None if mask is None else mask.expand(tuple(shape))


@dataclasses.dataclass(frozen=True)
class FacedStencilOperator:
    """Boundary-corrected constant stencil with dense low-face planes (the
    JAX package's legacy exact form of the linear-transfer Galerkin levels,
    superseded there by :class:`CorneredOperator`).

    * ``values``: (K,) interior taps, Dirichlet zero-truncated as in
      :class:`StencilOperator`'s constant mode.
    * ``face_axes``: the axes carrying a low-face correction.
    * ``face_coeffs``: per face axis, the exact ``(K, *shape-minus-axis)``
      coefficients of the rows ``i_axis == 0`` (edge and corner values
      included, so fixing faces in sequence is idempotent where they meet).

    The smoothers run the constant pass on the whole grid and then rewrite
    the face rows exactly.
    """

    values: torch.Tensor  # (K,)
    face_coeffs: tuple  # per face axis: (K, *shape_minus_axis)
    offsets: tuple
    shape: tuple
    face_axes: tuple

    @property
    def is_constant(self) -> bool:
        return False

    @property
    def is_faced(self) -> bool:
        return True

    @property
    def grid_shape(self) -> tuple:
        return tuple(self.shape)

    @property
    def ndim(self) -> int:
        return len(self.offsets[0])

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def num_offsets(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def const_op(self) -> StencilOperator:
        """The interior constant stencil as a plain operator."""
        return StencilOperator(None, self.offsets, self.values, self.shape)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)

    def face_inv_diag(self, face_index: int) -> torch.Tensor:
        """Exact 1/diag plane of ``face_axes[face_index]``."""
        di = diag_index(self.offsets)
        return 1.0 / self.face_coeffs[face_index][di]

    def astype(self, dtype) -> "FacedStencilOperator":
        return dataclasses.replace(
            self,
            values=self.values.to(dtype),
            face_coeffs=tuple(f.to(dtype) for f in self.face_coeffs),
        )

    def to_varying(self) -> StencilOperator:
        """Materialize the full ``(K, *grid)`` coefficient tensor (value ×
        in-domain mask, then the face planes), equal to the JAX package's
        bit for bit."""
        ks = []
        for k, off in enumerate(self.offsets):
            mask = _in_domain_mask(off, self.shape, self.device)
            if mask is None:
                ks.append(
                    torch.full(self.shape, 0.0, dtype=self.dtype,
                               device=self.device) + self.values[k]
                )
            else:
                ks.append(self.values[k] * mask.to(self.dtype))
        coeffs = torch.stack(ks)
        for fi, a in enumerate(self.face_axes):
            coeffs.select(a + 1, 0).copy_(self.face_coeffs[fi])
        return StencilOperator(coeffs, self.offsets)


def region_table(op: CorneredOperator) -> torch.Tensor:
    """Per-(region, offset) cumulative tap table, ``(n_regions, K)``.

    ``tbl[r, k] = values[k] + Σ_{S ⊆ R_r ∩ Z(o_k)} deltas[S][k]`` — the
    exact tap a row in region ``R_r`` uses for offset ``k``.  Summed in the
    operator's dtype in the order of ``subsets``, so the table equals the
    JAX package's bit for bit.
    """
    rows = []
    for R in op.regions:
        row = op.values
        for si, S in enumerate(op.subsets):
            if not set(S) <= set(R):
                continue
            m = torch.tensor(
                [all(off[b] == 0 for b in S) for off in op.offsets],
                dtype=op.values.dtype,
                device=op.values.device,
            )
            row = row + op.deltas[si] * m
        rows.append(row)
    return torch.stack(rows)


def diag_index(offsets) -> int:
    zero = (0,) * len(offsets[0])
    return tuple(offsets).index(zero)


def shift(x: torch.Tensor, off) -> torch.Tensor:
    """``z[i] = x[i + off]`` with zeros outside the domain (static offset),
    on the last ``len(off)`` axes: leading axes (a batch) are kept."""
    if all(o == 0 for o in off):
        return x
    pad = []
    for o in reversed(tuple(off)):  # F.pad lists the last dim first
        pad += [max(0, -o), max(0, o)]
    xp = F.pad(x, pad)
    grid = x.shape[x.ndim - len(off):]
    idx = tuple(slice(max(0, o), max(0, o) + n) for o, n in zip(off, grid))
    return xp[(Ellipsis,) + idx]


def _lead(op, x) -> int:
    """Leading axes of ``x`` before ``op``'s grid: 1 for a batch, else 0."""
    return x.ndim - op.ndim


def _region_rows(x, R, index=0, lead=0):
    """Rows with ``i_b == index_b`` for each ``b ∈ R`` (size-1 kept dims);
    grid axis ``b`` is axis ``lead + b`` of ``x``."""
    out = x
    for b in R:
        ib = index[b] if isinstance(index, dict) else index
        out = out.narrow(lead + b, ib, 1)
    return out


def _region_apply(op: CorneredOperator, tbl, r: int, R, x, exclude_diag=False):
    """Exact ``(A x)`` (or ``(A − D) x``) restricted to the region rows of
    ``R``; taps are the 0-d ``tbl[r, k]`` entries."""
    di = diag_index(op.offsets)
    lead = _lead(op, x)
    acc = None
    for k, off in enumerate(op.offsets):
        if exclude_diag and k == di:
            continue
        if any(off[b] < 0 for b in R):
            continue  # neighbour at i_b = −1 is outside the domain
        src = _region_rows(x, R, index={b: off[b] for b in R}, lead=lead)
        rest = tuple(0 if b in R else o for b, o in enumerate(off))
        term = tbl[r, k] * shift(src, rest)
        acc = term if acc is None else acc + term
    return acc


def _write_region(arr, R, block, lead=0):
    """Write ``block`` (size-1 dims on axes in R) into the index-0 rows of
    ``arr`` in place; ``arr`` must be a fresh tensor owned by the caller."""
    idx = (slice(None),) * lead + tuple(
        slice(0, 1) if b in R else slice(None) for b in range(arr.ndim - lead)
    )
    arr[idx] = block
    return arr


def _once(op, key, make):
    """``make()``, computed once per operator instance and kept on it (the
    operators are immutable dataclasses, so it cannot go stale)."""
    cache = op.__dict__
    if key not in cache:
        cache[key] = make()
    return cache[key]


def face_apply(
    op: FacedStencilOperator, face_index: int, x: torch.Tensor,
    exclude_diag: bool = False,
) -> torch.Tensor:
    """Exact ``(A x)`` (or ``(A − D) x``) on the low face of
    ``op.face_axes[face_index]``, a plane.  It reads the planes ``i_a ∈ {0,
    1}`` only, padded with zeros (the plane ``i_a = −1`` and the rim), takes
    every tap's shifted plane as a view, and sums ``fc[k] · plane_k`` over
    the taps in one product and one reduction: a few launches a face, not a
    few a tap (the face rows are tensor code on the card too)."""
    lead = _lead(op, x)
    a = op.face_axes[face_index]
    di = diag_index(op.offsets)
    if exclude_diag:
        fc = _once(op, ("_face_offdiag", face_index), lambda: torch.cat([
            op.face_coeffs[face_index][:di],
            torch.zeros_like(op.face_coeffs[face_index][di:di + 1]),
            op.face_coeffs[face_index][di + 1:],
        ]))
    else:
        fc = op.face_coeffs[face_index]
    nb = min(2, x.shape[lead + a])
    # planes −1, 0, 1 along a first (then the batch axis, if any), a zero
    # rim on the other grid axes; every tap's shifted plane a view
    planes = x.narrow(lead + a, 0, nb).movedim(lead + a, 0)
    pad = [1, 1] * (op.ndim - 1) + [0, 0] * lead + [1, 2 - nb]
    P = F.pad(planes, pad)  # F.pad lists the last dim first
    rest_shape = planes.shape[1 + lead:]
    views = []
    for off in op.offsets:
        rest = [o for i, o in enumerate(off) if i != a]
        idx = (off[a] + 1,) + (slice(None),) * lead + tuple(
            slice(1 + o, 1 + o + n) for o, n in zip(rest, rest_shape)
        )
        views.append(P[idx])
    if not lead:
        return torch.sum(fc * torch.stack(views), dim=0)
    # a batch: the products of every member in one ``(K, taps, *plane)``
    # tensor, then each member's sum by the scalar call on its contiguous
    # block (one reduction over the batch need not add in the scalar order)
    prod = fc * torch.stack(views, dim=1)
    return torch.stack([torch.sum(p, dim=0) for p in prod])


def _fix_faces(op: FacedStencilOperator, y, planes_of):
    """Write ``planes_of(fi)`` into the low face ``face_axes[fi]`` of ``y``
    (a fresh tensor owned by the caller, or a batch of them), every plane
    computed before any is written."""
    lead = _lead(op, y)
    planes = [planes_of(fi) for fi in range(len(op.face_axes))]
    for a, p in zip(op.face_axes, planes):
        y.select(lead + a, 0).copy_(p)
    return y


def apply(op, x: torch.Tensor) -> torch.Tensor:
    """SpMV ``y = A x`` on grid-shaped ``x`` (gather-free)."""
    if isinstance(op, CorneredOperator):
        y = apply(op.const_op, x)
        tbl = op.table
        for r, R in enumerate(op.regions):
            y = _write_region(y, R, _region_apply(op, tbl, r, R, x), _lead(op, x))
        return y
    if isinstance(op, FacedStencilOperator):
        return _fix_faces(
            op, apply(op.const_op, x), lambda fi: face_apply(op, fi, x)
        )
    y = None
    for k, off in enumerate(op.offsets):
        t = op.coeff(k) * shift(x, off)
        y = t if y is None else y + t
    return y


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def kernel_taps_ok(offsets):
    """None if the per-pass kernel takes these taps, else the reason it does
    not: the one statement on the Python side of what the kernel reads (the
    CUDA source's own check is the last guard)."""
    if len(offsets) > 27 or any(abs(o) > 1 for off in offsets for o in off):
        return "a stencil of radius > 1 or of more than 27 taps"
    return None


def kernel_operands_ok(op, x: torch.Tensor):
    """None if the per-pass kernel (or its batched form, for a batch
    ``(K, *grid)``) takes ``op`` on ``x``, else the reason it does not (used
    where a CUDA tensor must reach a kernel or raise)."""
    if x.dtype != torch.float32 or op.dtype != torch.float32:
        return f"{x.dtype} operands with a {op.dtype} operator (float32 only)"
    if op.ndim not in (1, 2, 3) or _lead(op, x) not in (0, 1):
        return f"a {x.ndim}D tensor with a {op.ndim}D operator (1D to 3D only)"
    return kernel_taps_ok(op.offsets)


def _residual_kernel(op, b, x):
    """``b − A x`` through the per-pass kernel (one launch), or raise."""
    from openmg_tpu_torch.ops import kernels

    why = kernel_operands_ok(op, x)
    if why is not None:
        raise NotImplementedError(
            f"residual on {b.device}: {why} is not taken by the per-pass "
            "kernel, and plain tensor code does not run on the card"
        )
    corner = (op.regions, op.table) if isinstance(op, CorneredOperator) else None
    if _lead(op, x):
        if corner is not None or op.is_constant:
            return kernels.half_sweep_batch(op.values, op.offsets, b, x,
                                            "residual", corner=corner)
        return kernels.half_sweep_vary_batch(op.coeffs, op.offsets, b, x,
                                             "residual")
    if corner is not None or op.is_constant:
        return kernels.residual_const_3d(op.values, op.offsets, b, x,
                                         corner=corner)
    return kernels.residual_vary_3d(op.coeffs, op.offsets, b, x)


def residual(op, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``r = b − A x``: plain tensor code for CPU tensors, the per-pass
    kernel for any other device (see the module docstring)."""
    lead = _lead(op, b)
    if isinstance(op, FacedStencilOperator):
        return _fix_faces(
            op, residual(op.const_op, b, x),
            lambda fi: b.select(lead + op.face_axes[fi], 0) - face_apply(op, fi, x),
        )
    if not _on_cpu(b):
        return _residual_kernel(op, b, x)
    if isinstance(op, CorneredOperator):
        r = b - apply(op.const_op, x)
        tbl = op.table
        for ri, R in enumerate(op.regions):
            rr = _region_rows(b, R, lead=lead) - _region_apply(op, tbl, ri, R, x)
            r = _write_region(r, R, rr, lead)
        return r
    return b - apply(op, x)
