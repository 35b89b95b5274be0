"""The port's multi-rank dry run: the three solves of the JAX package's
``__graft_entry__.py::dryrun_multichip(8)`` on gloo CPU ranks, one process
a rank.

    python scripts/dryrun_multichip_torch.py [--ranks 8] [--timeout 600]

The parent starts the ranks (this script again, with ``--rank``), joined
through a file store in a temporary directory, and prints rank 0's three
lines:

1. the stencil engine on a 1D mesh at ``(max(32, 8·n), 8, 16)``, three
   levels (the first two partitioned), red/black V(2,2), linear transfers;
2. the banded general-sparse engine: 2D Poisson in ELL at ``(8·n, 16)``;
3. the stencil engine with MG-PCG(2) on a ``(2, n/2)`` mesh.

Each solve must converge below 1e-10 in the cycle count the JAX package's
dry run recorded on 8 devices (``MULTICHIP_r05.json``: 7, 6 and 3); the
residuals may differ at the double-float floor.  Exits non-zero otherwise,
or when a rank fails or runs past ``--timeout`` seconds.  Imports torch and
the port only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# MULTICHIP_r05.json: the JAX package's dry run on 8 devices
RECORD_CYCLES = {"stencil": 7, "sparse": 6, "pcg": 3}


def rank_main(rank: int, n: int, store: str) -> None:
    import torch

    sys.path.insert(0, ROOT)
    from openmg_tpu_torch import (
        MeshConfig,
        SolverConfig,
        distributed_setup,
        setup_sparse_distributed,
    )
    from openmg_tpu_torch.models.poisson import poisson, rhs_random
    from openmg_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(init_method="file://" + store, rank=rank, world_size=n,
                           backend="gloo")
    lines, failures = [], []

    def check(tag, info, want):
        if not (info["converged"] and info["final_norm"] < 1e-10):
            failures.append(f"{tag}: not converged: {info['residual_norms']}")
        if n == 8 and info["cycles"] != want:
            failures.append(f"{tag}: {info['cycles']} cycles, the record {want}")

    shape = (max(32, 8 * n), 8, 16)
    cfg = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
               gridlevels=3, cycles=60, max_dense_coarse=int(np.prod(shape)))
    solver = distributed_setup(shape, SolverConfig(**cfg), MeshConfig(n_devices=n),
                               device="cpu")
    if not (solver.plan[0] and solver.plan[1]):
        failures.append(f"stencil plan {solver.plan}: no partitioned coarsening")
    b = rhs_random(shape, seed=0)
    b = b / np.linalg.norm(b.ravel())
    _, info = solver.solve(b)
    check("stencil", info, RECORD_CYCLES["stencil"])
    hist = info["residual_norms"]
    lines.append(
        f"dryrun_multichip_torch({n}): [stencil/1D-mesh] "
        f"plan={info['partition_plan']} cycles={info['cycles']} "
        f"residual {hist[0]:.3e} -> {hist[-1]:.3e} converged={info['converged']}")

    sshape = (8 * n, 16)
    scfg = SolverConfig(smoother="rbgs", transfer="linear", format="ell",
                        residual_dtype="doublefloat", gridlevels=3, cycles=60,
                        max_dense_coarse=int(np.prod(sshape)))
    ssolver = setup_sparse_distributed(poisson(sshape), sshape, scfg,
                                       MeshConfig(n_devices=n), device="cpu")
    if not ssolver.plan[0]:
        failures.append(f"sparse plan {ssolver.plan}: fine level not partitioned")
    sb = rhs_random(sshape, seed=1).reshape(-1)
    _, sinfo = ssolver.solve(sb / np.linalg.norm(sb))
    check("banded sparse", sinfo, RECORD_CYCLES["sparse"])
    lines.append(
        f"dryrun_multichip_torch({n}): [banded-sparse/1D-mesh] "
        f"plan={sinfo['partition_plan']} cycles={sinfo['cycles']} "
        f"final {sinfo['final_norm']:.3e} converged={sinfo['converged']}")

    if n >= 4 and n % 2 == 0:
        solver2 = distributed_setup(
            shape, SolverConfig(**cfg, krylov="pcg", krylov_iters=2),
            MeshConfig(mesh_shape=(2, n // 2), axis_names=("host", "chip")),
            device="cpu")
        _, info2 = solver2.solve(b)
        check("stencil + pcg", info2, RECORD_CYCLES["pcg"])
        lines.append(
            f"dryrun_multichip_torch({n}): [stencil+pcg/(2,{n // 2})-mesh] "
            f"plan={info2['partition_plan']} cycles={info2['cycles']} "
            f"final {info2['final_norm']:.3e} converged={info2['converged']}")
    torch.distributed.destroy_process_group()
    if rank == 0:
        print("\n".join(lines), flush=True)
    if failures:
        print("\n".join(failures), file=sys.stderr, flush=True)
        raise SystemExit(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.store)
        return 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ranks", str(args.ranks),
                 "--rank", str(r), "--store", store],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(args.ranks)
        ]
        outs, rcs = [], []
        try:
            for p in procs:
                left = max(1.0, args.timeout - (time.perf_counter() - t0))
                outs.append(p.communicate(timeout=left)[0])
                rcs.append(p.returncode)
        except subprocess.TimeoutExpired:
            rcs.append("timeout")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    print(outs[0] if outs else "", end="", flush=True)
    if len(rcs) != args.ranks or any(rc != 0 for rc in rcs):
        for r, out in enumerate(outs[1:], start=1):
            if rcs[r] != 0:
                print(f"--- rank {r}:\n{out[-3000:]}", file=sys.stderr)
        print(f"dryrun_multichip_torch: ranks exited {rcs}", file=sys.stderr)
        return 1
    print(f"dryrun_multichip_torch({args.ranks}): {time.perf_counter() - t0:.1f} s "
          f"on {args.ranks} gloo CPU ranks", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
