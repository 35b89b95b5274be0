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
        {"kind": "const" | "cornered",
         "offsets": ((0,0,0), ...), "shape": (nz, ny, nx),
         "values": (K,) array,
         # cornered only:
         "deltas": (n_subsets, K) array, "subsets": ((0,), (1,), ...)},
        ...
      ],
      "coarse_inv": (nc, nc) array,
      "stats": ((shape, n_offsets, nnz), ...),   # optional
    }

The double-float fine operator is the first level's ``values`` (hi) with a
zero lo part: the ported outer loop takes dyadic constant fine operators.
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

    levels, stats = [], []
    for lv in spec["levels"]:
        offsets = tuple(tuple(int(o) for o in off) for off in lv["offsets"])
        shape = tuple(int(s) for s in lv["shape"])
        values = np.asarray(lv["values"], dtype=np.float32)
        if lv["kind"] == "const":
            op = StencilOperator(None, offsets, put(values), shape)
        elif lv["kind"] == "cornered":
            op = CorneredOperator(
                values=put(values),
                deltas=put(lv["deltas"]),
                offsets=offsets,
                shape=shape,
                subsets=tuple(tuple(int(a) for a in S) for S in lv["subsets"]),
            )
        else:
            raise NotImplementedError(
                f"level kind {lv['kind']!r} is not ported (ROADMAP queue 1, "
                "items 15-16)"
            )
        inv_diag = put(np.float32(1.0) / values[diag_index(offsets)])
        levels.append(Level(A=op, inv_diag=inv_diag))
        stats.append((shape, len(offsets), None))
    fine = levels[0].A
    if not fine.is_constant:
        raise ValueError("the fine level must be a constant operator")
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
