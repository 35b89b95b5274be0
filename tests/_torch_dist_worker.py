"""One rank of the port's distributed tests: ``python _torch_dist_worker.py
RANK WORLD INIT_FILE CASES_JSON OUT_PREFIX``.

Imports torch, numpy and the port only (never JAX), joins a gloo group of
CPU ranks through a file store, runs every case of ``CASES_JSON`` (a list
of ``{"name", "shape", "config", "mesh", "seed"}``, and optionally
``"cut": k``: the solve is first cut after k cycles with a checkpoint, then
resumed from it; ``"many": seeds``: ``solve_many`` of those right-hand
sides) with
``openmg_tpu_torch.distributed_setup(..., device="cpu")`` and writes what
rank 0 saw to ``OUT_PREFIX.npz``: per case the solution, the residual
history, the cycle count and the partition plan, and the names of the
modules loaded (so a test can check that no JAX module was)."""

import json
import sys

import numpy as np
import torch


def main(argv):
    rank, world, init_file, cases_json, out = argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from openmg_tpu_torch import MeshConfig, SolverConfig, distributed_setup
    from openmg_tpu_torch.models.poisson import rhs_random
    from openmg_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(
        init_method="file://" + init_file, rank=rank, world_size=world,
        backend="gloo",
    )
    result = {}
    for case in json.loads(open(cases_json).read()):
        shape = tuple(case["shape"])
        cfg = SolverConfig(**case["config"])
        mesh = case["mesh"]
        mc = MeshConfig(**mesh)
        solver = distributed_setup(shape, cfg, mc, device="cpu")
        b = rhs_random(shape, seed=case.get("seed", 0))
        b = b / np.linalg.norm(b.ravel())
        name = case["name"]
        if "many" in case:
            bs = [rhs_random(shape, seed=sd) for sd in case["many"]]
            x, info = solver.solve_many([bb / np.linalg.norm(bb.ravel()) for bb in bs])
            info = dict(info, residual_norms=info["residual_norms"][0],
                        cycles=info["cycles"][0])
        elif "cut" in case:
            import dataclasses

            path = f"{out}_{name}.npz"
            cut = distributed_setup(
                shape, dataclasses.replace(cfg, cycles=case["cut"]), mc, device="cpu")
            _, ci = cut.solve(b, checkpoint_path=path)
            result[f"{name}/cut_cycles"] = np.int64(ci["cycles"])
            x, info = solver.solve(b, checkpoint_path=path, resume=True)
        else:
            x, info = solver.solve(b)
        result[f"{name}/x"] = x
        result[f"{name}/hist"] = np.asarray(info["residual_norms"])
        result[f"{name}/cycles"] = np.int64(info["cycles"])
        result[f"{name}/plan"] = np.asarray(info["partition_plan"])
        result[f"{name}/exchanges"] = np.int64(solver.comm.stats["exchanges"])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "openmg_tpu"))
    result["jax_modules"] = np.asarray(bad, dtype=str)
    if rank == 0:
        np.savez(out + ".npz", **result)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
