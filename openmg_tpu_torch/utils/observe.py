"""Observability: profiler traces, per-level breakdowns, structured reports
(twin of ``openmg_tpu/utils/observe.py``).

* :func:`trace` — ``torch.profiler`` around a block, its trace written to
  ``logdir`` (a Chrome trace; TensorBoard's profiler plugin reads it too):
  the device timeline shows the kernels by name.
* :func:`level_breakdown` — measured smoother time a sweep on every level
  and the nonzeros a second it reaches; on the card timed with CUDA events.
* :func:`solve_report` — one JSON-able record of a finished solve:
  configuration, hierarchy statistics, residual history, convergence factor
  and throughput, with the same keys as the JAX package's.
* :func:`pack_solve_meta` / :func:`unpack_solve_meta` — a solve's cycle
  count, residual history and convergence flag in one float32 vector, so a
  caller that keeps them on the device reads them back in one copy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

__all__ = [
    "trace",
    "level_breakdown",
    "solve_report",
    "dump_report",
    "convergence_factor",
    "pack_solve_meta",
    "unpack_solve_meta",
]


def pack_solve_meta(k, hist, done):
    """``(cycle count, residual history, converged)`` as ONE float32 tensor
    on the history's device: ``[k, done, hist...]``."""
    hist = torch.as_tensor(hist, dtype=torch.float32)
    head = torch.stack([
        torch.as_tensor(k, dtype=torch.float32, device=hist.device),
        torch.as_tensor(done, dtype=torch.float32, device=hist.device),
    ])
    return torch.cat([head, hist])


def unpack_solve_meta(packed):
    """Host side of :func:`pack_solve_meta`: one read, then
    ``(k, history list, converged)``."""
    if isinstance(packed, torch.Tensor):
        packed = packed.detach().cpu().numpy()
    arr = np.asarray(packed)
    k = int(arr[0])
    done = bool(arr[1] != 0.0)
    return k, [float(v) for v in arr[2 : 2 + k]], done


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the context (host and, where there is a
    card, device activity) and write the trace into ``logdir`` as
    ``trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


def _timeit(f, device, reps: int = 5) -> float:
    """Seconds a call of ``f``: CUDA events around ``reps`` calls on the
    card (after one warm call), the host clock on the CPU."""
    f()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            f()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        f()
    return (time.perf_counter() - t0) / reps


def level_breakdown(solver, sweeps: int = 4, reps: int = 5):
    """Smoother cost of every level of a stencil :class:`Solver`: shape,
    nonzeros, ms a sweep and nonzeros a second, through the same ``smooth``
    the cycle uses (on the card, its kernels; timed with CUDA events)."""
    from openmg_tpu_torch.ops.smoothers import smooth

    cfg = solver.config
    h = solver.hierarchy
    dev = h.device
    records = []
    for lvl in range(h.num_levels):
        L = h.levels[lvl]
        shape, _, nnz = h.stats[lvl]
        b = torch.zeros(tuple(shape), dtype=solver.dtype, device=dev)
        x = torch.ones(tuple(shape), dtype=solver.dtype, device=dev)

        def f(L=L, b=b, x=x):
            return smooth(cfg.smoother, L.A, L.inv_diag, b, x, sweeps, cfg.omega)

        dt = _timeit(f, dev, reps) / sweeps
        records.append(
            {
                "level": lvl,
                "shape": list(shape),
                "nnz": int(nnz),
                "constant": bool(L.A.is_constant),
                "smoother_ms_per_sweep": dt * 1e3,
                "smoother_nnz_per_s": nnz / dt,
            }
        )
    return records


def convergence_factor(residual_norms) -> float:
    """Geometric-mean per-cycle residual contraction ρ (the first cycle,
    which reflects the initial guess, is left out):
    ‖r_k‖ ≈ ρ^k ‖r_0‖."""
    r = np.asarray([float(v) for v in residual_norms], dtype=np.float64)
    r = r[r > 0]
    if len(r) < 3:
        return float("nan")
    return float((r[-1] / r[1]) ** (1.0 / (len(r) - 2)))


def _backend(solver) -> str:
    """The device kind the solve ran on: ``"gpu"`` or ``"cpu"`` (the JAX
    package's ``jax.default_backend()`` names)."""
    dev = getattr(solver, "device", None)
    if dev is None:
        dev = solver.hierarchy.device
    return "gpu" if torch.device(dev).type == "cuda" else torch.device(dev).type


def solve_report(solver, info: dict, include_levels: bool = False) -> dict:
    """One structured JSON-able record of a completed solve."""
    cfg = solver.config
    stats = info.get("level_stats", ())
    fine_nnz = int(stats[0][2]) if stats else None
    mean_cycle = info.get("mean_cycle_time_s")
    if mean_cycle is None or not np.isfinite(mean_cycle):
        cycle_times = info.get("cycle_times_s", [])
        steady = cycle_times[1:] or cycle_times
        mean_cycle = float(np.mean(steady)) if steady else None
    rec = {
        "config": dataclasses.asdict(cfg),
        "gridlevels": info.get("gridlevels"),
        "level_stats": [
            {"shape": list(s), "offsets": int(k), "nnz": int(n)}
            for (s, k, n) in stats
        ],
        "cycles": info.get("cycles"),
        "converged": info.get("converged"),
        "final_norm": info.get("final_norm"),
        "residual_norms": [float(v) for v in info.get("residual_norms", [])],
        "convergence_factor": convergence_factor(
            info.get("residual_norms", [])
        ),
        "residual_mode": info.get("residual_mode"),
        "mean_cycle_time_s": mean_cycle,
        "solve_time_s": info.get("solve_time_s"),
        "backend": _backend(solver),
    }
    if fine_nnz and mean_cycle:
        # smoother work a cycle on the fine level alone (a lower bound on
        # cycle throughput; the whole hierarchy adds at most 1/7 in 3D)
        sweeps = cfg.pre_iterations + cfg.post_iterations
        rec["fine_nnz"] = fine_nnz
        rec["cycle_smoother_nnz_per_s"] = fine_nnz * sweeps / mean_cycle
    # distributed solves carry their mesh facts through
    if "partition_plan" in info:
        rec["partition_plan"] = [bool(p) for p in info["partition_plan"]]
    if "n_devices" in info:
        rec["n_devices"] = int(info["n_devices"])
    if "outer_loop" in info:
        rec["outer_loop"] = info["outer_loop"]
    if include_levels:
        rec["levels"] = level_breakdown(solver)
    return rec


def dump_report(path, report: dict) -> None:
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
