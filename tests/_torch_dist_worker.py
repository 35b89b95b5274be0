"""One rank of the port's distributed tests: ``python _torch_dist_worker.py
RANK WORLD INIT_FILE CASES_JSON OUT_PREFIX``.

Imports torch, numpy, scipy and the port only (never JAX), joins a gloo
group of CPU ranks through a file store, runs every case of ``CASES_JSON``
and writes what rank 0 saw to ``OUT_PREFIX.npz``.  A case is ``{"name",
"shape", "config", "mesh", "seed"}``: a stencil solve of a grid shape
through ``openmg_tpu_torch.distributed_setup(..., device="cpu")``, or with
``"kind": "sparse"`` and a ``"matrix"`` (``tests/_torch_dist_cases.py``) a
general-sparse solve through ``setup_sparse_distributed``.  Optionally
``"cut": k`` (the solve is first cut after k cycles with a checkpoint, then
resumed from it), ``"many": seeds`` (``solve_many`` of those right-hand
sides, as a float32 tensor batch with ``"native"``, from host initial
guesses with ``"x0"``; then the scalar solves of the members listed in
``"scalars"``, each with its own ``Comm.stats``) or ``"expect_error": true``
(the constructor's error is recorded).

Per case: the solution, the residual history, the cycle count, the
partition plan and this rank's ``Comm.stats``, and for a scalar solve from
zero the communication model's numbers for the same solver
(``openmg_tpu_torch.parallel.model``); a batch's per member (``hist{m}``,
``cycles`` a vector, ``host_reads``); and the names of the modules loaded
(so a test can check that no JAX module was)."""

import json
import sys

import numpy as np
import torch


def _model(result, name, solver, sparse):
    from openmg_tpu_torch.parallel.model import comm_model, comm_model_sparse

    m = (comm_model_sparse if sparse else comm_model)(solver)
    for key in ("halo_bytes_per_cycle", "staged_bytes_per_cycle",
                "gathered_bytes_per_cycle", "delivery_gathered_bytes",
                "hbm_bytes_per_cycle", "efficiency_bound_overlap",
                "efficiency_bound_no_overlap", "comm_fraction_no_overlap"):
        result[f"{name}/model/{key}"] = np.float64(m[key])
    result[f"{name}/model/level_halo_bytes"] = np.asarray(
        [lv["halo_bytes"] for lv in m["per_level"]], dtype=np.float64)
    result[f"{name}/model/keys"] = np.asarray(sorted(m), dtype=str)
    result[f"{name}/model/deep_fused"] = np.asarray(
        [lv.get("deep_fused", False) for lv in m["per_level"]])


def _stats(result, key, solver):
    for k in ("exchanges", "bytes_sent", "staged_bytes", "gathered_bytes"):
        result[f"{key}/{k}"] = np.int64(solver.comm.stats[k])


def _merged(x, info, native):
    if not native:
        return x
    hi, lo = info["x_df"]
    return hi.double().numpy() + lo.double().numpy()


def _many(result, name, solver, case, rhs):
    """A batch's solve_many and the scalar solves of its ``scalars``."""
    native = bool(case.get("native"))
    bs = [rhs(sd) for sd in case["many"]]
    x0s = [0.01 * rhs(sd + 1000) for sd in case["many"]] if case.get("x0") else None
    if native:
        bs = torch.from_numpy(np.stack(bs).astype(np.float32))
    x, info = solver.solve_many(bs, x0s)
    result[f"{name}/x"] = _merged(x, info, native)
    for m, h in enumerate(info["residual_norms"]):
        result[f"{name}/hist{m}"] = np.asarray(h)
    result[f"{name}/cycles"] = np.asarray(info["cycles"], dtype=np.int64)
    result[f"{name}/converged"] = np.asarray(info["converged"])
    result[f"{name}/host_reads"] = np.int64(info["host_reads"])
    result[f"{name}/plan"] = np.asarray(info["partition_plan"])
    _stats(result, name, solver)
    for m in case["scalars"]:
        solver.comm.reset_stats()
        xm, im = solver.solve(bs[m], None if x0s is None else x0s[m])
        key = f"{name}/scalar{m}"
        result[f"{key}/x"] = _merged(xm, im, native)
        result[f"{key}/hist"] = np.asarray(im["residual_norms"])
        _stats(result, key, solver)


def main(argv):
    rank, world, init_file, cases_json, out = argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from _torch_dist_cases import matrix_of, sparse_rhs

    from openmg_tpu_torch import (
        MeshConfig,
        SolverConfig,
        distributed_setup,
        setup_sparse_distributed,
    )
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
        mc = MeshConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in mesh.items()})
        name = case["name"]
        sparse = case.get("kind") == "sparse"
        if sparse:
            A = matrix_of(case)

            def build(c):
                return setup_sparse_distributed(A, shape, c, mc, device="cpu")

            def rhs(seed):
                return sparse_rhs(A.shape[0], seed)
        else:
            def build(c):
                return distributed_setup(shape, c, mc, device="cpu")

            def rhs(seed):
                b = rhs_random(shape, seed=seed)
                return b / np.linalg.norm(b.ravel())
        if case.get("expect_error"):
            try:
                build(cfg)
            except ValueError as e:
                result[f"{name}/error"] = np.asarray(str(e))
            continue
        solver = build(cfg)
        b = rhs(case.get("seed", 0))
        solver.comm.reset_stats()
        scalar = False
        if "many" in case:
            _many(result, name, solver, case, rhs)
            continue
        if "cut" in case:
            import dataclasses

            path = f"{out}_{name}.npz"
            cut = build(dataclasses.replace(cfg, cycles=case["cut"]))
            _, ci = cut.solve(b, checkpoint_path=path)
            result[f"{name}/cut_cycles"] = np.int64(ci["cycles"])
            x, info = solver.solve(b, checkpoint_path=path, resume=True)
        else:
            x, info = solver.solve(b)
            scalar = True
        result[f"{name}/x"] = x
        result[f"{name}/hist"] = np.asarray(info["residual_norms"])
        result[f"{name}/cycles"] = np.int64(info["cycles"])
        result[f"{name}/plan"] = np.asarray(info["partition_plan"])
        _stats(result, name, solver)
        if scalar:
            _model(result, name, solver, sparse)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "openmg_tpu"))
    result["jax_modules"] = np.asarray(bad, dtype=str)
    if rank == 0:
        np.savez(out + ".npz", **result)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
