"""The cases of the port's distributed tests and the one run of their ranks.

Three test files read what the ranks saw (``tests/test_torch_dist.py``,
``tests/test_torch_sparse_dist.py``, ``tests/test_torch_model.py``).  The
ranks run once a test session, in two spawns (2 ranks, and 4 ranks for the
(2, 2) mesh) of ``tests/_torch_dist_worker.py``: under xdist the first
worker to ask runs them while holding a lock in the session's shared
temporary directory, and the others wait for that lock and read its
results.

The sparse cases' matrices and right-hand sides are the port's
(``openmg_tpu_torch/models/spd.py``, which ``chip_smoke.py`` reads too).
"""

import fcntl
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

from openmg_tpu_torch.models.spd import irregular_spd, pentadiag, unit_rhs

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
WORKER = HERE / "_torch_dist_worker.py"
TIMEOUT_S = 120

# -- the stencil engine ---------------------------------------------------

CFG = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
           gridlevels=3, cycles=60)
CASES = {
    # name: (ranks, config overrides, mesh)
    "v": (2, {}, {"n_devices": 2}),
    "w": (2, {"cycle_type": "w"}, {"n_devices": 2}),
    "f": (2, {"cycle_type": "f"}, {"n_devices": 2}),
    "pcg2_mesh2x2": (4, {"krylov": "pcg", "krylov_iters": 2}, {"mesh_shape": [2, 2]}),
}
# a 2D grid cut along y: its passes run on (ny, 1, nx) slabs
SHAPE_2D = (64, 32)
CFG_2D = dict(CFG, max_dense_coarse=4096)


def shape_of(P):
    return (max(32, 8 * P), 8, 16)


def config_of(name):
    P, over, _ = CASES[name]
    return dict(CFG, max_dense_coarse=int(np.prod(shape_of(P))), **over)


# -- the general sparse engine --------------------------------------------

def matrix_of(case):
    """The matrix of a sparse case: ``poisson`` on the case's grid,
    ``pentadiag`` or ``irregular`` of its ``n`` rows."""
    kind, shape = case["matrix"], tuple(case["shape"])
    if kind == "poisson":
        from openmg_tpu_torch.models.poisson import poisson

        return poisson(shape)
    if kind == "pentadiag":
        return pentadiag(shape[0])
    return irregular_spd(shape[0], case.get("matrix_seed", 0))


SPARSE_CFG = dict(format="ell", residual_dtype="doublefloat", cycles=60,
                  max_dense_coarse=64)
PENTA = (512,)
SPARSE_CASES = {
    # name: (ranks, matrix, shape, config overrides, mesh)
    # the dry run's banded-sparse case (__graft_entry__.py) at P = 2
    "sp_dry": (2, "poisson", (16, 16),
               dict(smoother="rbgs", transfer="linear", gridlevels=3,
                    max_dense_coarse=256), {"n_devices": 2}),
    "sp_jacobi": (2, "pentadiag", PENTA, dict(smoother="jacobi"), {"n_devices": 2}),
    "sp_rbgs": (2, "pentadiag", PENTA, dict(smoother="rbgs"), {"n_devices": 2}),
    "sp_cheb": (2, "pentadiag", PENTA, dict(smoother="chebyshev"), {"n_devices": 2}),
    "sp_w": (2, "pentadiag", PENTA, dict(smoother="rbgs", cycle_type="w"),
             {"n_devices": 2}),
    "sp_f": (2, "pentadiag", PENTA, dict(smoother="rbgs", cycle_type="f"),
             {"n_devices": 2}),
    "sp_irregular": (2, "irregular", PENTA, dict(smoother="jacobi"), {"n_devices": 2}),
    "sp_irregular_rbgs": (2, "irregular", PENTA, dict(smoother="rbgs"),
                          {"n_devices": 2}),
    "sp_dry_mesh2x2": (4, "poisson", (16, 16),
                       dict(smoother="rbgs", transfer="linear", gridlevels=3,
                            max_dense_coarse=256), {"mesh_shape": [2, 2]}),
    "sp_pcg2_mesh2x2": (4, "pentadiag", PENTA,
                        dict(smoother="rbgs", krylov="pcg", krylov_iters=2),
                        {"mesh_shape": [2, 2]}),
}
SPARSE_SEED = 1


def sparse_case(name):
    P, matrix, shape, over, mesh = SPARSE_CASES[name]
    return {"name": name, "kind": "sparse", "matrix": matrix, "shape": list(shape),
            "config": dict(SPARSE_CFG, **over), "mesh": mesh, "seed": SPARSE_SEED}


def sparse_rhs(n, seed=SPARSE_SEED):
    return unit_rhs(n, seed)


def port_cases(world):
    out = []
    for name, (P, _, mesh) in CASES.items():
        if P == world:
            out.append({"name": name, "shape": shape_of(P), "config": config_of(name),
                        "mesh": mesh})
    v2d = {"name": "v2d", "shape": SHAPE_2D, "config": CFG_2D, "mesh": {"n_devices": 2}}
    if world == 2:
        out.append({"name": "v_resumed", "shape": shape_of(2), "config": config_of("v"),
                    "mesh": CASES["v"][2], "cut": 3})
        out.append(v2d)
    by_name = {c["name"]: c for c in out}
    out += [many_case(by_name[n], n) for n in MANY if n in by_name]
    if world == 2:
        out.append(many_case(by_name["v"], "v", native_x0=True))
    sparse = [sparse_case(name) for name, c in SPARSE_CASES.items() if c[0] == world]
    out += sparse
    by_name = {c["name"]: c for c in sparse}
    out += [many_case(by_name[n], n) for n in SPARSE_MANY if n in by_name]
    if world == 2:
        out.append(many_case(by_name["sp_rbgs"], "sp_rbgs", native_x0=True))
        # 1001 rows do not split over two ranks: the constructor raises
        out.append(dict(sparse_case("sp_jacobi"), name="sp_indivisible",
                        shape=[1001], expect_error=True))
    return out


# -- solve_many: one stack of MANY_K members ------------------------------

MANY_K = 3
# the cases whose solver also runs a batch (``<name>_many``): the seeds of
# its scalar case and two more, the scalar solves of the two run beside it
MANY = ("v", "w", "f", "v2d", "pcg2_mesh2x2")
SPARSE_MANY = ("sp_rbgs", "sp_cheb", "sp_irregular", "sp_pcg2_mesh2x2")


def many_seeds(case):
    first = case.get("seed", 0)
    return [first] + [first + 10 + m for m in range(1, MANY_K)]


def many_name(name, native_x0=False):
    return f"{name}_many_native_x0" if native_x0 else f"{name}_many"


def many_case(case, name, native_x0=False):
    """``solve_many`` of ``many_seeds`` on the solver of ``case``, and the
    scalar solves of the members its scalar case does not solve (every
    member where the batch is a float32 tensor from host ``x0s``: the
    card-batch contract, run on CPU tensors)."""
    seeds = many_seeds(case)
    out = dict(case, name=many_name(name, native_x0), many=seeds,
               scalars=list(range(0 if native_x0 else 1, len(seeds))))
    if native_x0:
        out.update(native=True, x0=True)
    return out


# -- the spawns -----------------------------------------------------------

def spawn(tmp, world, cases):
    """Run ``cases`` on ``world`` gloo ranks; rank 0's results."""
    tmp.mkdir(parents=True, exist_ok=True)
    cases_json = tmp / "cases.json"
    cases_json.write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(tmp / "store"),
             str(cases_json), str(tmp / "out")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    with np.load(tmp / "out.npz") as z:
        return {k: z[k] for k in z.files}


def results(tmp_path_factory):
    """Every case's results from the two spawns, run once a session."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    done = root / "torch_dist_ranks.npz"
    with open(root / "torch_dist_ranks.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                res = {}
                for world in (2, 4):
                    res.update(spawn(root / f"torch_dist_ranks{world}", world,
                                     port_cases(world)))
                part = root / "torch_dist_ranks.part.npz"
                np.savez(part, **res)
                os.replace(part, done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with np.load(done) as z:
        return {k: z[k] for k in z.files}


def lam_min(shape):
    """The least eigenvalue of the Dirichlet Poisson operator on ``shape``."""
    return sum(2 - 2 * np.cos(np.pi / (n + 1)) for n in shape)


def assert_solves_agree(hist, x, want_hist, want_x, lam):
    """Equal cycle counts, histories within rtol 1e-3 (the norms are sums in
    another order), both below 1e-10, and ‖x − x_want‖₂ ≤ 2e-10/λ_min (both
    within the threshold of the one solution)."""
    assert len(hist) == len(want_hist), (hist, want_hist)
    np.testing.assert_allclose(hist, want_hist, rtol=1e-3)
    assert hist[-1] < 1e-10
    assert x.shape == want_x.shape
    assert np.linalg.norm((x - want_x).ravel()) <= 2e-10 / lam


def assert_many_equals_scalars(port, case_name, native_x0=False):
    """The batch of ``case_name``'s solver against the scalar solves of its
    members on the same ranks: every member converged, bit-equal (iterate
    and norm history, so its cycles too); one host read a step; the
    exchanges of the longest member's scalar solve (one a step carries every
    member's planes); and the bytes sent, staged and gathered the sum of
    the members' scalar solves."""
    name = many_name(case_name, native_x0)
    xs, cycles = port[f"{name}/x"], port[f"{name}/cycles"]
    assert xs.shape[0] == MANY_K == len(cycles)
    assert port[f"{name}/converged"].all()
    scalars = []
    for m in range(MANY_K):
        key = case_name if m == 0 and not native_x0 else f"{name}/scalar{m}"
        scalars.append(key)
        np.testing.assert_array_equal(xs[m], port[f"{key}/x"], err_msg=f"{name} member {m}")
        np.testing.assert_array_equal(port[f"{name}/hist{m}"], port[f"{key}/hist"])
        assert cycles[m] == len(port[f"{key}/hist"]) - 1
    assert int(port[f"{name}/host_reads"]) == int(cycles.max()) + 1
    assert int(port[f"{name}/exchanges"]) == max(int(port[f"{k}/exchanges"]) for k in scalars)
    for k in ("bytes_sent", "staged_bytes", "gathered_bytes"):
        assert int(port[f"{name}/{k}"]) == sum(int(port[f"{s}/{k}"]) for s in scalars), k
    return name
