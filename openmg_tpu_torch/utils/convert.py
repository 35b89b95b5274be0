"""Carry a hierarchy across as plain numpy.

:func:`hierarchy_from_numpy` builds the port's
:class:`~openmg_tpu_torch.core.hierarchy.Hierarchy`, and
:func:`sparse_hierarchy_from_numpy` its
:class:`~openmg_tpu_torch.core.algebraic.SparseHierarchy`, from a dictionary
of numpy arrays and Python tuples, however they were produced.  The tests
fill them from another implementation's hierarchy, so that the cycle and the
solve can be compared with the setup held equal; this module itself knows
only numpy and the port.

``spec`` layout::

    {
      "transfer": "linear" | "aggregate",
      "levels": [            # finest first
        {"kind": "const" | "cornered" | "faced" | "varying",
         "offsets": ((0,0,0), ...), "shape": (nz, ny, nx),
         "values": (K,) array,             # const, cornered, faced
         # cornered only:
         "deltas": (n_subsets, K) array, "subsets": ((0,), (1,), ...),
         # faced only: per face axis its (K, *shape-minus-axis) plane
         "face_axes": (0, 1, 2), "face_coeffs": [array, ...],
         # varying only:
         "coeffs": (K, nz, ny, nx) array},
        ...
      ],
      "coarse_inv": (nc, nc) array,
      "stats": ((shape, n_offsets, nnz), ...),   # optional
      # optional: the double-float fine operator, each {"offsets", "shape",
      # and "values" or "coeffs"}
      "fine_hi": {...}, "fine_hi_lo": {...},
    }

Without ``fine_hi`` the double-float fine operator is the first level's
``values`` (hi) with a zero lo part, which needs a constant first level.

``sparse_hierarchy_from_numpy``'s ``spec``: the fields of a sparse
hierarchy, each container as a dictionary of its fields plus ``"format"``
(``"ell"``, ``"csr"``, ``"bsr"`` or ``"dense"``)::

    {
      "fmt": "ell", "shapes": ((ny, nx), ...) | None,
      "transfer_name": "linear" | None, "dofs": 1, "stats": (...),
      "levels": [{"A": {...}, "inv_diag": (n,), "R": {...} | None,
                  "P": {...} | None, "colors": (n,) | None,
                  "num_colors": int, "lam_max": float}, ...],
      "coarse_inv": (nc, nc), "fine_hi": {...}, "fine_lo": {...} | None,
    }

Arrays keep their numpy dtype (float32 or float64 values, int32 indices).
"""

from __future__ import annotations

import numpy as np
import torch

from openmg_tpu_torch.core.hierarchy import Hierarchy, Level
from openmg_tpu_torch.ops.stencil import (
    CorneredOperator,
    FacedStencilOperator,
    StencilOperator,
    diag_index,
)
from openmg_tpu_torch.ops.transfer import TRANSFERS

__all__ = ["hierarchy_from_numpy", "sparse_hierarchy_from_numpy"]


def hierarchy_from_numpy(spec: dict, device) -> Hierarchy:
    device = torch.device(device)

    def put(a):
        a = np.array(a, dtype=np.float32)  # a writable, contiguous copy
        return torch.from_numpy(a).to(device)

    def plain_op(d):
        offsets = tuple(tuple(int(o) for o in off) for off in d["offsets"])
        if d.get("coeffs") is not None:
            return StencilOperator(put(d["coeffs"]), offsets)
        shape = tuple(int(s) for s in d["shape"])
        return StencilOperator(None, offsets, put(d["values"]), shape)

    levels, stats = [], []
    for lv in spec["levels"]:
        kind = lv["kind"]
        if kind in ("const", "varying"):
            op = plain_op(lv)
        elif kind == "cornered":
            op = CorneredOperator(
                values=put(lv["values"]),
                deltas=put(lv["deltas"]),
                offsets=tuple(tuple(int(o) for o in off) for off in lv["offsets"]),
                shape=tuple(int(s) for s in lv["shape"]),
                subsets=tuple(tuple(int(a) for a in S) for S in lv["subsets"]),
            )
        elif kind == "faced":
            op = FacedStencilOperator(
                values=put(lv["values"]),
                face_coeffs=tuple(put(p) for p in lv["face_coeffs"]),
                offsets=tuple(tuple(int(o) for o in off) for off in lv["offsets"]),
                shape=tuple(int(s) for s in lv["shape"]),
                face_axes=tuple(int(a) for a in lv["face_axes"]),
            )
        else:
            raise ValueError(f"unknown level kind {kind!r}")
        di = diag_index(op.offsets)
        diag = np.asarray(
            lv["coeffs"][di] if kind == "varying" else lv["values"][di],
            dtype=np.float32,
        )
        levels.append(Level(A=op, inv_diag=put(np.float32(1.0) / diag)))
        stats.append((op.grid_shape, len(op.offsets), None))
    if spec.get("fine_hi") is not None:
        fine, fine_lo = plain_op(spec["fine_hi"]), plain_op(spec["fine_hi_lo"])
    else:
        fine = levels[0].A
        if not fine.is_constant:
            raise ValueError(
                "without 'fine_hi' the fine level must be a constant operator"
            )
        fine_lo = StencilOperator(
            None, fine.offsets, put(np.zeros(len(fine.offsets))), fine.grid_shape
        )
    return Hierarchy(
        levels=tuple(levels),
        coarse_inv=put(spec["coarse_inv"]),
        fine_hi=fine,
        fine_hi_lo=fine_lo,
        stats=tuple(spec.get("stats") or stats),
        transfer=TRANSFERS[spec["transfer"]],
    )


def _copy(a, device):
    """A numpy array as a tensor on ``device`` (a writable copy, its dtype
    kept); None passes through."""
    return None if a is None else torch.from_numpy(np.array(a)).to(device)


def _container_from_numpy(d, device):
    from openmg_tpu_torch.ops import sparse

    if d is None:
        return None
    shape = tuple(int(s) for s in d.get("shape", ()))
    offs = d.get("slot_offsets")
    offs = None if offs is None else tuple(int(o) for o in offs)
    fmt = d["format"]
    if fmt == "ell":
        return sparse.ELLMatrix(
            data=_copy(d["data"], device), cols=_copy(d["cols"], device),
            shape=shape, nnz=int(d["nnz"]), bandwidth=int(d.get("bandwidth", 0)),
            slot_offsets=offs,
        )
    if fmt == "csr":
        return sparse.CSRMatrix(
            data=_copy(d["data"], device), indices=_copy(d["indices"], device),
            row_ids=_copy(d["row_ids"], device), shape=shape, nnz=int(d["nnz"]),
        )
    if fmt == "bsr":
        return sparse.BSRMatrix(
            data=_copy(d["data"], device), bcols=_copy(d["bcols"], device),
            shape=shape, blocksize=tuple(int(b) for b in d["blocksize"]),
            nnz=int(d["nnz"]), slot_offsets=offs,
        )
    if fmt == "dense":
        return sparse.DenseMatrix(data=_copy(d["data"], device), nnz=int(d["nnz"]))
    raise ValueError(f"unknown container format {fmt!r}")


def sparse_hierarchy_from_numpy(spec: dict, device):
    from openmg_tpu_torch.core.algebraic import SparseHierarchy, SparseLevel

    device = torch.device(device)
    levels = []
    for lv in spec["levels"]:
        inv_diag = _copy(lv["inv_diag"], device)
        levels.append(SparseLevel(
            A=_container_from_numpy(lv["A"], device),
            inv_diag=inv_diag,
            R=_container_from_numpy(lv.get("R"), device),
            P=_container_from_numpy(lv.get("P"), device),
            colors=_copy(lv.get("colors"), device),
            num_colors=int(lv["num_colors"]),
            lam_max=torch.tensor(float(lv["lam_max"]), dtype=inv_diag.dtype,
                                 device=device),
        ))
    shapes = spec.get("shapes")
    return SparseHierarchy(
        levels=tuple(levels),
        coarse_inv=_copy(spec["coarse_inv"], device),
        fine_hi=_container_from_numpy(spec["fine_hi"], device),
        fine_lo=_container_from_numpy(spec.get("fine_lo"), device),
        stats=tuple(spec.get("stats") or ()),
        fmt=spec["fmt"],
        shapes=None if shapes is None else tuple(tuple(int(v) for v in s) for s in shapes),
        transfer_name=spec.get("transfer_name"),
        dofs=int(spec.get("dofs", 1)),
    )
