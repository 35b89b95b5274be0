"""Grid-hierarchy construction (twin of ``openmg_tpu/core/hierarchy.py``).

Three build functions:

* :func:`build_hierarchy_structured` for constant fine stencils (Poisson),
  with its level classification.  The whole Galerkin chain is computed on
  the host in boundary-collapsed form
  (:mod:`openmg_tpu_torch.core.structured`); a level that is exactly
  constant is stored as a ``(K,)`` value vector, a level that is constant
  away from its low faces/edges/corner as a
  :class:`~openmg_tpu_torch.ops.stencil.CorneredOperator` (an O(K) table),
  and one that is constant away from its low faces only as a
  :class:`~openmg_tpu_torch.ops.stencil.FacedStencilOperator` (dense face
  planes).  None of these kinds streams coefficient grids during a sweep.
  With ``faced=False`` every level that is not constant is stored as
  per-point coefficient grids (``varying``) with a grid of inverse
  diagonals, as in the JAX package.
* :func:`build_hierarchy` for a general ``(offsets, coeffs)`` stencil pair
  (diffusion, a matrix's extracted stencil): the Galerkin chain on full
  coefficient arrays on the host (:mod:`openmg_tpu_torch.ops.galerkin`),
  each level stored as a constant operator where it is exactly one and as
  ``(K, *grid)`` coefficient grids otherwise, with a grid of inverse
  diagonals.
* :func:`build_hierarchy_device`, the same chain as tensor code on the
  hierarchy's device (coefficient grids given as a tensor, or a constant
  fine stencil materialized there for the chain's first step only): the
  RAP steps, inverse diagonals, nonzero counts and constancy statistics
  never leave the device; only the statistics' few scalars (to prune the
  offsets and store the constant levels) and the coarsest level (for its
  dense inverse) are read to the host.

Level data and the coarsest level's dense inverse are placed on ``device``.

The coarsest level is factored into an explicit dense inverse so the
in-cycle coarse solve is a single matrix–vector product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openmg_tpu_torch.models.poisson import stencil_to_csr
from openmg_tpu_torch.ops.galerkin import galerkin_rap_stencil, rap_output_offsets
from openmg_tpu_torch.ops.stencil import (
    CorneredOperator,
    FacedStencilOperator,
    StencilOperator,
    _in_domain_mask,
    diag_index,
)
from openmg_tpu_torch.ops.transfer import AGGREGATE, Transfer, coarse_shape

__all__ = [
    "Level",
    "Hierarchy",
    "build_hierarchy",
    "build_hierarchy_device",
    "build_hierarchy_structured",
    "default_gridlevels",
    "detect_constant",
    "detect_cornered",
    "detect_faced",
]


@dataclasses.dataclass(frozen=True)
class Level:
    A: StencilOperator | CorneredOperator | FacedStencilOperator
    # 1/diag: 0-d (constant / cornered interior) or a grid (varying)
    inv_diag: torch.Tensor

    @property
    def grid_shape(self):
        return self.A.grid_shape


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: tuple  # tuple[Level, ...], finest first
    coarse_inv: torch.Tensor  # (nc, nc) dense inverse of the coarsest operator
    fine_hi: StencilOperator  # fine operator for the outer residual
    # double-float residual mode: fine_hi holds the f32 hi coefficients and
    # fine_hi_lo the f32 lo remainders (exact two-f32 split of the f64
    # operator).  Plain modes: fine_hi in the residual dtype, fine_hi_lo None.
    fine_hi_lo: StencilOperator | None
    stats: tuple  # static per-level (shape, num_offsets, true_nnz)
    transfer: Transfer  # static intergrid transfer spec

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def grid_shape(self):
        return self.levels[0].grid_shape

    @property
    def device(self):
        return self.coarse_inv.device


def default_gridlevels(shape, max_dense_coarse: int, min_coarse_dim: int = 1) -> int:
    """Full-depth level count: coarsen while factor-2 coarsening is legal
    and the current level is still too big for the dense coarse solve."""
    shape = [int(s) for s in shape]
    levels = 1
    while int(np.prod(shape)) > max_dense_coarse:
        if not (
            all(s == 1 or s % 2 == 0 for s in shape)
            and any(s > 1 for s in shape)
            and all(s == 1 or s // 2 >= min_coarse_dim for s in shape)
        ):
            break
        shape = [max(1, s // 2) for s in shape]
        levels += 1
    return levels


def _interior_slice(off, shape):
    return tuple(
        slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape)
    )


def _exists_mask(off, shape):
    """Boolean grid: True where the neighbor at ``off`` stays in-domain."""
    m = np.ones(shape, dtype=bool)
    for ax, o in enumerate(off):
        idx = [slice(None)] * len(shape)
        if o > 0:
            idx[ax] = slice(0, shape[ax] - o)
        elif o < 0:
            idx[ax] = slice(-o, None)
        else:
            continue
        mm = np.zeros(shape, dtype=bool)
        mm[tuple(idx)] = True
        m &= mm
    return m


def detect_faced(offsets, coeffs):
    """Detect the boundary-corrected constant structure: the operator equals
    a constant Dirichlet-truncated stencil at every point with all
    coordinates ≥ 1, deviating only on the low faces ``i_axis == 0``.

    This is exactly the structure of Galerkin coarsenings of constant
    operators under the separable radius-1 ``linear`` transfer (each 1D
    factor matrix is Toeplitz-tridiagonal except its [0, 0] entry — see
    the JAX package's ``FacedStencilOperator``).  Returns
    ``(values, face_axes, face_planes)`` with ``face_planes[j]`` the exact
    ``(K, *shape-minus-axis)`` coefficients of face ``face_axes[j]``, or
    None when the structure does not hold.

    ``coeffs`` may be the full coefficient array OR a boundary-collapsed
    representative (structured.StructuredLevel.rep): the rep is an exact
    materialization for its own dummy shape, and expansion only replicates
    interior rows, so detection on the rep proves the property for every
    real extent.
    """
    shape = coeffs.shape[1:]
    if any(s < 3 for s in shape):
        return None
    mid = tuple(s // 2 for s in shape)
    vals = np.array([coeffs[k][mid] for k in range(coeffs.shape[0])])
    interior = tuple(slice(1, None) for _ in shape)
    deviating = []
    for k, off in enumerate(offsets):
        expect = vals[k] * _exists_mask(off, shape)
        if not np.array_equal(coeffs[k][interior], expect[interior]):
            return None
        deviating.append(not np.array_equal(coeffs[k], expect))
    if not any(deviating):
        return None  # exactly constant — caller should use the plain path
    face_axes, face_planes = [], []
    for a in range(len(shape)):
        plane = np.take(coeffs, 0, axis=a + 1)
        expect = np.stack(
            [
                np.take(vals[k] * _exists_mask(off, shape), 0, axis=a)
                for k, off in enumerate(offsets)
            ]
        )
        if not np.array_equal(plane, expect):
            face_axes.append(a)
            face_planes.append(plane)
    if not face_axes:
        return None
    return vals, tuple(face_axes), face_planes


def detect_cornered(offsets, coeffs):
    """Detect the corner-collapsed structure (the sharp form of
    :func:`detect_faced` — see :class:`~openmg_tpu_torch.ops.stencil.
    CorneredOperator`): the tap at row ``i`` for offset ``o`` depends only
    on ``{b : i_b == 0 and o_b == 0}``.  Exact over the whole array
    (verified by rebuilding it from the extracted table and comparing
    bit-for-bit).  Returns ``(values, subsets, deltas)`` in inclusion–
    exclusion form, or None.

    ``coeffs`` may be a boundary-collapsed representative (see
    :func:`detect_faced` — the argument carries over unchanged).
    """
    import itertools

    shape = coeffs.shape[1:]
    d = len(shape)
    if any(s < 3 for s in shape):
        return None
    K = coeffs.shape[0]
    mid = tuple(s // 2 for s in shape)
    base = np.array([coeffs[k][mid] for k in range(K)])

    all_subsets = []
    for size in range(1, d + 1):
        all_subsets.extend(
            tuple(c) for c in itertools.combinations(range(d), size)
        )
    # Möbius extraction: delta_S[k] = g_S[k] − base[k] − Σ_{S'⊊S} delta_S'[k]
    deltas = {}
    for S in all_subsets:
        pt = tuple(0 if b in S else mid[b] for b in range(d))
        dS = np.zeros(K, dtype=coeffs.dtype)
        for k, off in enumerate(offsets):
            if not all(off[b] == 0 for b in S):
                continue  # tap never uses this delta
            g = coeffs[k][pt]
            acc = base[k]
            for Sp in all_subsets:
                if Sp != S and set(Sp) < set(S):
                    acc += deltas[Sp][k]
            dS[k] = g - acc
        deltas[S] = dS
    subsets = tuple(S for S in all_subsets if np.any(deltas[S]))
    if not subsets:
        return None  # exactly constant — the plain constant path applies

    # exact verification: rebuild every coefficient array from the table
    for k, off in enumerate(offsets):
        tap = np.full(shape, base[k], dtype=coeffs.dtype)
        for S in subsets:
            if not all(off[b] == 0 for b in S):
                continue
            sel = np.ones(shape, dtype=bool)
            for b in S:
                idx = [slice(None)] * d
                idx[b] = slice(1, None)
                m = np.ones(shape, dtype=bool)
                m[tuple(idx)] = False
                sel &= m
            tap = tap + deltas[S][k] * sel
        expect = tap * _exists_mask(off, shape)
        if not np.array_equal(coeffs[k], expect):
            return None
    return base, subsets, tuple(deltas[S] for S in subsets)


def detect_constant(offsets, coeffs):
    """Return the ``(K,)`` value vector if the (numpy) operator is exactly
    constant-coefficient with zero Dirichlet truncation, else None."""
    shape = coeffs.shape[1:]
    vals = []
    for k, off in enumerate(offsets):
        sl = _interior_slice(off, shape)
        interior = coeffs[k][sl]
        if interior.size == 0:
            vals.append(coeffs.dtype.type(0))
            continue
        v = interior.flat[0]
        if not (interior == v).all():
            return None
        vals.append(v)
        # the out-of-domain slabs must be exactly zero: every nonzero of
        # the full array must lie in the interior region
        if np.count_nonzero(coeffs[k]) != np.count_nonzero(interior):
            return None
    return np.asarray(vals, dtype=coeffs.dtype)


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _np_dtype(dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


def _level_from_np(offs, cfs_np, dtype, device):
    """Build a Level (constant representation when detected) from numpy
    coefficient arrays."""
    offs = tuple(offs)
    di = diag_index(offs)
    diag = cfs_np[di]
    if np.any(diag == 0):
        raise ValueError("operator has zero diagonal entries")
    np_dtype = _np_dtype(dtype)
    vals = detect_constant(offs, cfs_np)
    shape = tuple(int(s) for s in cfs_np.shape[1:])
    if vals is not None:
        op = StencilOperator(None, offs, _put(vals.astype(np_dtype), device), shape)
        inv_diag = _put(np.asarray(1.0 / vals[di]).astype(np_dtype), device)
    else:
        op = StencilOperator(_put(cfs_np.astype(np_dtype), device), offs)
        inv_diag = _put((1.0 / diag).astype(np_dtype), device)
    return Level(A=op, inv_diag=inv_diag)


def _residual_op_from_np(offs, cfs_np, device):
    """Residual-path operator: constant representation when possible (the
    zero lo part of an exactly-representable operator costs no memory)."""
    vals = detect_constant(offs, cfs_np)
    shape = tuple(int(s) for s in cfs_np.shape[1:])
    if vals is not None:
        return StencilOperator(None, offs, _put(vals, device), shape)
    return StencilOperator(_put(cfs_np, device), offs)


def build_hierarchy(
    offsets,
    coeffs,
    gridlevels=None,
    dtype=torch.float32,
    residual_dtype=None,
    transfer: Transfer = AGGREGATE,
    max_dense_coarse: int = 512,
    min_coarse_dim: int = 1,
    setup_dtype="float32",
    *,
    device,
) -> Hierarchy:
    """Host-path hierarchy build from a fine-level stencil (numpy coeffs).

    Levels are cast to ``dtype`` for the cycle; the fine operator is
    additionally kept at ``residual_dtype`` precision for the outer
    defect-correction residual: ``"doublefloat"`` stores an exact two-f32
    split of the *original* (full-precision) input instead of one array, a
    torch dtype stores one array of that type.  ``device`` is where the
    level data and the coarse inverse are placed.
    """
    device = torch.device(device)
    orig_coeffs = np.asarray(coeffs)
    shape = tuple(int(s) for s in orig_coeffs.shape[1:])
    if gridlevels is None:
        gridlevels = default_gridlevels(shape, max_dense_coarse, min_coarse_dim)
    coeffs = np.asarray(orig_coeffs, dtype=np.dtype(setup_dtype))

    chain = [(tuple(tuple(int(o) for o in off) for off in offsets), coeffs)]
    for _ in range(int(gridlevels) - 1):
        offs, cfs = chain[-1]
        c_offs, c_cfs = galerkin_rap_stencil(offs, cfs, transfer=transfer)
        chain.append((tuple(c_offs), c_cfs))

    coarse_inv = _coarse_inverse(
        chain[-1], max_dense_coarse, single_level=len(chain) == 1
    )

    levels, stats = [], []
    for offs, cfs in chain:
        levels.append(_level_from_np(offs, cfs, dtype, device))
        stats.append(
            (
                tuple(int(s) for s in cfs.shape[1:]),
                len(offs),
                int(np.count_nonzero(cfs)),
            )
        )

    fine_offs = chain[0][0]
    rdtype = residual_dtype or dtype
    fine_hi_lo = None
    if rdtype == "doublefloat":
        if orig_coeffs.dtype == np.float32:
            hi, lo = orig_coeffs, np.zeros_like(orig_coeffs)
        else:
            o64 = orig_coeffs.astype(np.float64, copy=False)
            hi = o64.astype(np.float32)
            lo = (o64 - hi).astype(np.float32)
        fine_hi = _residual_op_from_np(fine_offs, hi, device)
        fine_hi_lo = _residual_op_from_np(fine_offs, lo, device)
    else:
        fine_hi = StencilOperator(
            _put(
                orig_coeffs.astype(np.float64, copy=False).astype(_np_dtype(rdtype)),
                device,
            ),
            fine_offs,
        )
    return Hierarchy(
        levels=tuple(levels),
        coarse_inv=_put(coarse_inv.astype(_np_dtype(dtype)), device),
        fine_hi=fine_hi,
        fine_hi_lo=fine_hi_lo,
        stats=tuple(stats),
        transfer=transfer,
    )


_UNCOARSENABLE_DENSE_CAP = 4096  # hard guard for the single-level escape


def _coarse_inverse(coarsest, max_dense_coarse, single_level: bool = False):
    c_offs, c_cfs = coarsest
    nc = int(np.prod(c_cfs.shape[1:]))
    if nc > max_dense_coarse:
        # a problem that cannot coarsen AT ALL (odd extents, tiny grids)
        # degrades to the reference's plain dense solve rather than
        # erroring — but only up to a hard cap, so an accidental 256³
        # "1-level" request can never densify a gigarow matrix
        if single_level and nc <= _UNCOARSENABLE_DENSE_CAP:
            import warnings

            warnings.warn(
                f"grid cannot be coarsened; solving its {nc} unknowns "
                f"directly (above max_dense_coarse={max_dense_coarse})",
                stacklevel=3,
            )
        else:
            raise ValueError(
                f"coarsest level has {nc} unknowns > max_dense_coarse="
                f"{max_dense_coarse}; increase gridlevels (or "
                "max_dense_coarse)"
            )
    Ac = stencil_to_csr(
        c_offs, np.asarray(c_cfs, dtype=np.float64)
    ).toarray()
    return np.linalg.inv(Ac)


def classify_level(offsets, rep):
    """``(kind, payload)`` of one boundary-collapsed level: ``const`` with
    its ``(K,)`` values, ``cornered`` with ``(values, subsets, deltas)``,
    ``faced`` with ``(values, face_axes, face_planes)``, or ``varying`` (no
    payload)."""
    vals = detect_constant(offsets, rep)
    if vals is not None:
        return "const", vals
    cd = detect_cornered(offsets, rep)
    if cd is not None:
        return "cornered", cd
    fd = detect_faced(offsets, rep)
    if fd is not None:
        return "faced", fd
    return "varying", None


def build_hierarchy_structured(
    offsets,
    fine_values,
    shape,
    gridlevels=None,
    dtype=torch.float32,
    residual_dtype="doublefloat",
    transfer: Transfer = AGGREGATE,
    max_dense_coarse: int = 512,
    min_coarse_dim: int = 1,
    faced: bool = True,
    *,
    device,
) -> Hierarchy:
    """Hierarchy from a constant fine stencil via the boundary-collapsed
    chain (:mod:`openmg_tpu_torch.core.structured`): the exact Galerkin
    hierarchy computed on 24-wide dummy grids on the host.  ``device`` is
    where the level tables and the coarse inverse are placed.

    ``faced=True`` stores a level that is constant away from its low faces
    as a :class:`~openmg_tpu_torch.ops.stencil.CorneredOperator`, or as a
    :class:`~openmg_tpu_torch.ops.stencil.FacedStencilOperator` where the
    sharper cornered form does not hold;
    ``faced=False`` stores every level that is not constant as coefficient
    grids, expanded on ``device`` from the level's representative, with
    ``inv_diag = 1 / coeffs[diag]`` per point (the JAX package's
    ``faced=False``, which its distributed builder uses)."""
    from openmg_tpu_torch.core.structured import (
        expand_rep,
        expand_rep_np,
        structured_chain,
    )

    device = torch.device(device)
    np_dtype = _np_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    offsets = tuple(tuple(o) for o in offsets)
    if gridlevels is None:
        gridlevels = default_gridlevels(shape, max_dense_coarse, min_coarse_dim)
    slevels = structured_chain(
        offsets, fine_values, shape, int(gridlevels), transfer
    )

    def put(a):
        return _put(a, device)

    levels, stats = [], []
    for i, lvl in enumerate(slevels):
        kind, payload = classify_level(lvl.offsets, lvl.rep)
        if not faced and kind in ("cornered", "faced"):
            kind = "varying"
        di = diag_index(lvl.offsets)
        if kind == "varying":
            coeffs = expand_rep(
                put(lvl.rep.astype(np_dtype)), lvl.m_shape, lvl.real_shape
            )
            op, inv_diag = StencilOperator(coeffs, lvl.offsets), 1.0 / coeffs[di]
        elif kind == "const":
            vals = payload
            op = StencilOperator(
                None, lvl.offsets, put(vals.astype(np_dtype)), lvl.real_shape
            )
        elif kind == "cornered":
            vals, subsets, devs = payload
            op = CorneredOperator(
                values=put(vals.astype(np_dtype)),
                deltas=put(np.stack(devs).astype(np_dtype)),
                offsets=lvl.offsets,
                shape=lvl.real_shape,
                subsets=subsets,
            )
        else:
            vals, face_axes, face_planes = payload
            # each (collapsed) face plane expanded over its remaining axes
            planes = []
            for a, plane in zip(face_axes, face_planes):
                rest = [
                    (m, n) for j, (m, n) in
                    enumerate(zip(lvl.m_shape, lvl.real_shape)) if j != a
                ]
                for ax, (m, n) in enumerate(rest):
                    if m < n:
                        plane = expand_rep_np(plane, ax, n)
                planes.append(put(plane.astype(np_dtype)))
            op = FacedStencilOperator(
                values=put(vals.astype(np_dtype)),
                face_coeffs=tuple(planes),
                offsets=lvl.offsets,
                shape=lvl.real_shape,
                face_axes=face_axes,
            )
        if kind != "varying":
            inv_diag = put(np.asarray(1.0 / vals[di]).astype(np_dtype))
        levels.append(Level(A=op, inv_diag=inv_diag))
        stats.append((lvl.real_shape, len(lvl.offsets), lvl.nnz()))

    # coarsest dense inverse from the (tiny) exact materialization
    last = slevels[-1]
    c_full = last.rep
    for a in range(len(last.real_shape)):
        if last.m_shape[a] < last.real_shape[a]:
            c_full = expand_rep_np(c_full, a, last.real_shape[a])
    coarse_inv = _coarse_inverse(
        (last.offsets, c_full), max_dense_coarse,
        single_level=len(slevels) == 1,
    )

    fine_op = levels[0].A
    if not fine_op.is_constant:
        raise ValueError("structured setup requires a constant fine operator")
    if residual_dtype == "doublefloat":
        fine_hi = fine_op
        fine_hi_lo = StencilOperator(
            None,
            fine_op.offsets,
            put(np.zeros(len(fine_op.offsets), dtype=np_dtype)),
            fine_op.grid_shape,
        )
    else:
        fine_hi = fine_op.astype(residual_dtype)
        fine_hi_lo = None
    return Hierarchy(
        levels=tuple(levels),
        coarse_inv=put(coarse_inv.astype(np_dtype)),
        fine_hi=fine_hi,
        fine_hi_lo=fine_hi_lo,
        stats=tuple(stats),
        transfer=transfer,
    )


# ---------------------------------------------------------------------------
# setup on the device
# ---------------------------------------------------------------------------


def _materialize_constant(values, offsets, shape, dtype):
    """A constant stencil as full ``(K, *shape)`` coefficient grids with
    Dirichlet zero truncation (value × in-domain mask), on the device of
    ``values``."""
    ks = []
    for k, off in enumerate(offsets):
        mask = _in_domain_mask(off, shape, values.device)
        v = values[k].to(dtype)
        if mask is None:
            ks.append(torch.zeros(shape, dtype=dtype, device=values.device) + v)
        else:
            ks.append(v * mask.to(dtype))
    return torch.stack(ks)


def _interior_stats(cur, offsets, shape):
    """Per offset, the min and max of its grid over the rows whose
    neighbour stays in the grid (0 where there is none): two ``(K,)``
    tensors on the device."""
    mins, maxs = [], []
    zero = torch.zeros((), dtype=cur.dtype, device=cur.device)
    for k, off in enumerate(offsets):
        if all(s - abs(o) > 0 for o, s in zip(off, shape)):
            inner = cur[k][_interior_slice(off, shape)]
            mins.append(inner.min())
            maxs.append(inner.max())
        else:
            mins.append(zero)
            maxs.append(zero)
    return torch.stack(mins), torch.stack(maxs)


def build_hierarchy_device(
    offsets,
    coeffs=None,
    *,
    fine_values=None,
    shape=None,
    gridlevels=None,
    dtype=torch.float32,
    residual_dtype="doublefloat",
    transfer: Transfer = AGGREGATE,
    max_dense_coarse: int = 512,
    min_coarse_dim: int = 1,
    device,
) -> Hierarchy:
    """Setup on the device: the Galerkin chain as tensor code on ``device``.

    Pass either ``coeffs`` (``(K, *shape)`` coefficient grids, a tensor or
    an array; moved to ``device`` in ``dtype``) or ``fine_values`` +
    ``shape`` (a constant fine stencil such as Poisson: its grids are
    materialized on the device for the first RAP step only and never
    stored).

    Every level's RAP step, inverse diagonal, nonzero count and per-offset
    interior min/max run on the device.  A level whose interior min and max
    agree for every offset is stored as a constant ``(K,)`` operator (its
    zero offsets pruned), any other as coefficient grids with the offsets
    that are zero everywhere pruned; the few scalars that decide this are
    read to the host, one read a level.  The coarsest level is read to the
    host for its dense inverse.  With ``residual_dtype="doublefloat"`` the
    fine operator's lo part is zero: the chain solves the operator as given
    in ``dtype``.
    """
    device = torch.device(device)
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    if fine_values is not None:
        if shape is None:
            raise ValueError("shape is required with fine_values")
        shape = tuple(int(s) for s in shape)
        values = torch.tensor(
            [float(v) for v in fine_values], dtype=dtype, device=device
        )
        cur = _materialize_constant(values, offsets, shape, dtype)
    else:
        cur = torch.as_tensor(coeffs).to(device=device, dtype=dtype)
        shape = tuple(int(s) for s in cur.shape[1:])
    if gridlevels is None:
        gridlevels = default_gridlevels(shape, max_dense_coarse, min_coarse_dim)

    levels, stats = [], []
    cur_offs, cur_shape = offsets, shape
    for lvl in range(int(gridlevels)):
        if lvl > 0:
            want = rap_output_offsets(cur_offs, cur_shape, transfer)
            cur_offs, cur = galerkin_rap_stencil(
                cur_offs, cur, transfer=transfer, prune=False
            )
            assert tuple(cur_offs) == tuple(want)
            cur_shape = coarse_shape(cur_shape)
        mins, maxs = _interior_stats(cur, cur_offs, cur_shape)
        nz_any = torch.any(cur.reshape(cur.shape[0], -1) != 0, dim=1)
        nnz = torch.count_nonzero(cur)
        # the level's scalars, in one read
        host = torch.cat(
            [mins.double(), maxs.double(), nz_any.double(), nnz.double()[None]]
        ).cpu().numpy()
        K = len(cur_offs)
        mins_h, maxs_h, nz_h = host[:K], host[K:2 * K], host[2 * K:3 * K]
        nnz_val = int(host[3 * K])
        if np.all(mins_h == maxs_h):
            keep = [
                i for i in range(K) if not (mins_h[i] == 0 and maxs_h[i] == 0)
            ] or [0]
            offs_k = tuple(cur_offs[i] for i in keep)
            vals = mins[keep]
            op = StencilOperator(None, offs_k, vals, cur_shape)
            inv_diag = 1.0 / vals[diag_index(offs_k)]
        else:
            keep = [i for i in range(K) if nz_h[i]] or [0]
            offs_k = tuple(cur_offs[i] for i in keep)
            op = StencilOperator(cur[keep] if len(keep) < K else cur, offs_k)
            inv_diag = 1.0 / op.coeffs[diag_index(offs_k)]
        levels.append(Level(A=op, inv_diag=inv_diag))
        stats.append((cur_shape, len(offs_k), nnz_val))

    coarse_op = levels[-1].A
    if coarse_op.is_constant:
        c_vals = coarse_op.values.double().cpu().numpy()
        c_cfs = np.zeros((len(coarse_op.offsets),) + cur_shape)
        for k, off in enumerate(coarse_op.offsets):
            c_cfs[(k,) + _interior_slice(off, cur_shape)] = c_vals[k]
    else:
        c_cfs = coarse_op.coeffs.double().cpu().numpy()
    coarse_inv = _coarse_inverse(
        (coarse_op.offsets, c_cfs), max_dense_coarse,
        single_level=len(levels) == 1,
    )

    fine_op = levels[0].A
    if residual_dtype == "doublefloat":
        fine_hi = fine_op
        fine_hi_lo = StencilOperator(
            None, fine_op.offsets,
            torch.zeros(len(fine_op.offsets), dtype=dtype, device=device),
            fine_op.grid_shape,
        )
    else:
        fine_hi = fine_op.astype(residual_dtype)
        fine_hi_lo = None
    return Hierarchy(
        levels=tuple(levels),
        coarse_inv=_put(coarse_inv.astype(_np_dtype(dtype)), device),
        fine_hi=fine_hi,
        fine_hi_lo=fine_hi_lo,
        stats=tuple(stats),
        transfer=transfer,
    )
