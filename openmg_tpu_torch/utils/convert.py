"""Carry a hierarchy across as plain numpy.

:func:`hierarchy_from_numpy` builds the port's
:class:`~openmg_tpu_torch.core.hierarchy.Hierarchy` from a dictionary of
numpy arrays and Python tuples, however they were produced.  The tests fill
it from another implementation's hierarchy, so that the cycle and the solve
can be compared with the setup held equal; this module itself knows only
numpy and the port.

``spec`` layout::

    {
      "transfer": "linear" | "aggregate",
      "levels": [            # finest first
        {"kind": "const" | "cornered" | "varying",
         "offsets": ((0,0,0), ...), "shape": (nz, ny, nx),
         "values": (K,) array,             # const, cornered
         # cornered only:
         "deltas": (n_subsets, K) array, "subsets": ((0,), (1,), ...),
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
"""

from __future__ import annotations

import numpy as np
import torch

from openmg_tpu_torch.core.hierarchy import Hierarchy, Level
from openmg_tpu_torch.ops.stencil import (
    CorneredOperator,
    StencilOperator,
    diag_index,
)
from openmg_tpu_torch.ops.transfer import TRANSFERS

__all__ = ["hierarchy_from_numpy"]


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
        else:
            raise NotImplementedError(
                f"level kind {kind!r} is not ported (ROADMAP queue 1, item 15)"
            )
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
