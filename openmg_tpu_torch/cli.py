"""Solve / benchmark command line (twin of ``openmg_tpu/cli.py``).

Usage::

    python -m openmg_tpu_torch --shape 64 64 64 [--config cfg.json] [--report out.json]
    python -m openmg_tpu_torch --shape 256 256 256 --smoother rbgs --transfer linear
    python -m openmg_tpu_torch --shape 64 64 64 --devices 4 --device cpu   # distributed

``--config`` loads a :class:`SolverConfig` from JSON (what
``SolverConfig.to_json`` writes); explicit flags override it.  The
structured report (configuration, level statistics, residual history,
convergence factor, throughput) goes to stdout or to ``--report``.

``--device`` is ``cuda`` (the default: a card; each rank its own,
``cuda:{LOCAL_RANK}``), ``cuda:N`` (every rank on card N: gloo with host
staging), or ``cpu`` (gloo).  ``--devices N`` (or ``--mesh-shape H C``)
runs the distributed solve on N ranks: under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` set) each process is one rank; otherwise this command
starts the N ranks itself, as local processes joined through a file store,
and prints rank 0's report.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def build_parser():
    ap = argparse.ArgumentParser(
        prog="openmg_tpu_torch",
        description="geometric multigrid on the GPU (PyTorch / CUDA)",
    )
    ap.add_argument("--shape", type=int, nargs="+", required=True,
                    help="grid shape, e.g. --shape 256 256 256")
    ap.add_argument("--config", help="SolverConfig JSON file")
    ap.add_argument("--smoother", choices=["jacobi", "rbgs", "chebyshev"])
    ap.add_argument("--transfer", choices=["aggregate", "linear"])
    ap.add_argument("--cycle-type", choices=["v", "w", "f"])
    ap.add_argument("--cycles", type=int)
    ap.add_argument("--threshold", type=float)
    ap.add_argument("--gridlevels", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--krylov", choices=["none", "pcg"],
                    help="MG-preconditioned CG outer steps (stencil engine)")
    ap.add_argument("--krylov-iters", type=int)
    ap.add_argument("--devices", type=int, default=0,
                    help=">1: distributed solve over this many ranks")
    ap.add_argument("--mesh-shape", type=int, nargs=2, metavar=("HOSTS", "CHIPS"),
                    help="2-axis (host, chip) mesh for the distributed solve")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card a rank), cuda:N (every rank on card N) or cpu")
    ap.add_argument("--levels", action="store_true",
                    help="include the measured per-level smoother breakdown")
    ap.add_argument("--report", help="write the JSON report here")
    ap.add_argument("--verbose", action="store_true")
    return ap


def _spawn(argv, n):
    """Start ``n`` local ranks of this command (each with ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and a file store) and wait for them;
    rank 0 prints the report."""
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   OMG_INIT_METHOD="file://" + store)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "openmg_tpu_torch", *argv], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL,
        ))
    rcs = [p.wait() for p in procs]
    return max(rcs, key=abs)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    n_mesh = args.mesh_shape[0] * args.mesh_shape[1] if args.mesh_shape else 0
    n_ranks = max(args.devices, n_mesh)
    distributed = n_ranks > 1
    if distributed and "WORLD_SIZE" not in os.environ:
        return _spawn(argv, n_ranks)

    import dataclasses

    import numpy as np
    import torch

    from openmg_tpu_torch import MeshConfig, SolverConfig, distributed_setup, setup
    from openmg_tpu_torch.models.poisson import rhs_random
    from openmg_tpu_torch.utils.observe import level_breakdown, solve_report

    if args.config:
        with open(args.config) as f:
            cfg = SolverConfig.from_json(f.read())
    else:
        cfg = SolverConfig()
    overrides = {
        k: v
        for k, v in {
            "smoother": args.smoother,
            "transfer": args.transfer,
            "cycle_type": args.cycle_type,
            "cycles": args.cycles,
            "threshold": args.threshold,
            "gridlevels": args.gridlevels,
            "krylov": args.krylov,
            "krylov_iters": args.krylov_iters,
            "verbose": args.verbose or None,
        }.items()
        if v is not None
    }
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    shape = tuple(args.shape)
    rank = int(os.environ.get("RANK", "0"))
    say = (lambda *a: print(*a, file=sys.stderr, flush=True)) if rank == 0 else (
        lambda *a: None)
    say(f"# setup {shape} ...")
    t0 = time.perf_counter()
    if distributed:
        from openmg_tpu_torch.parallel.mesh import initialize_distributed

        dev = torch.device(args.device)
        shared = dev.type == "cuda" and dev.index is not None
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        initialize_distributed(
            init_method=os.environ.get("OMG_INIT_METHOD"),
            backend="gloo" if dev.type == "cpu" or shared else "nccl",
            device=dev,
        )
        mc = (MeshConfig(mesh_shape=tuple(args.mesh_shape)) if args.mesh_shape
              else MeshConfig(n_devices=args.devices))
        solver = distributed_setup(shape, cfg, mc, device=dev)
    else:
        solver = setup(shape, cfg, device=args.device)
    setup_s = time.perf_counter() - t0

    b = rhs_random(shape, seed=args.seed)
    b = b / np.linalg.norm(b.ravel())
    say("# solving ...")
    x, info = solver.solve(b)
    x, info = solver.solve(b)  # warm timing (the first call builds the kernels)

    rep = solve_report(solver, info)
    rep["setup_s"] = setup_s
    rep["shape"] = list(shape)
    if args.levels and not distributed:
        rep["levels"] = level_breakdown(solver)
    if distributed:
        torch.distributed.destroy_process_group()
        if rank != 0:
            return 0
    out = json.dumps(rep, indent=2, sort_keys=True, default=float)
    if args.report:
        with open(args.report, "w") as f:
            f.write(out)
        say(f"# report -> {args.report}")
    else:
        print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
