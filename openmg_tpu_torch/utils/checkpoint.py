"""Checkpoint / resume between outer cycles (twin of
``openmg_tpu/utils/checkpoint.py``).

The outer defect-correction loop's state is ``(x, cycle index)``: the
hierarchy is deterministic and rebuilt from the configuration.  A
checkpoint is one ``.npz`` file with the full-precision iterate (the exact
float64 merge of the double-float pair; ``df_split`` on load gives the pair
back bit for bit), the cycle counter, the residual history and a hash of
the solver configuration and grid shape.

Host-only numpy code, copied from the JAX package (the port imports
nothing of it): the same file format and the same hash, so a checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

__all__ = ["config_hash", "save_checkpoint", "load_checkpoint"]

_VERSION = 1


def config_hash(config, grid_shape) -> str:
    """Stable hash of (solver config, grid shape): a checkpoint resumes only
    into a solver with the same per-cycle iteration map on the same problem.
    The stopping criteria (``cycles``, ``threshold``), ``verbose`` and
    ``outer_loop`` do not change that map and are left out, so a run can be
    resumed with a higher cycle cap or a tighter tolerance."""
    fields = json.loads(config.to_json())
    for k in ("cycles", "threshold", "verbose", "outer_loop"):
        fields.pop(k, None)
    payload = json.dumps(
        {"config": fields, "shape": list(grid_shape)}, sort_keys=True
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save_checkpoint(path, x_np, cycle: int, residual_norms, cfg_hash: str):
    """Write the solve state atomically (a temporary file, then a rename)."""
    path = str(path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=np.int64(_VERSION),
                x=np.asarray(x_np, dtype=np.float64),
                cycle=np.int64(cycle),
                residual_norms=np.asarray(residual_norms, dtype=np.float64),
                cfg_hash=np.str_(cfg_hash),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path, cfg_hash: str):
    """Load a checkpoint: ``(x, cycle, residual_norms)``; raises
    ``ValueError`` when it was written for another configuration."""
    with np.load(str(path)) as z:
        if int(z["version"]) != _VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        stored = str(z["cfg_hash"])
        if stored != cfg_hash:
            raise ValueError(
                f"checkpoint config hash {stored} != solver {cfg_hash}; "
                "refusing to resume into a different solver/problem"
            )
        return (
            np.asarray(z["x"], dtype=np.float64),
            int(z["cycle"]),
            [float(v) for v in z["residual_norms"]],
        )
