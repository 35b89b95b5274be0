#!/usr/bin/env python3
"""Where a solve of the PyTorch/CUDA port spends its time, by kernel.

    python3 scripts/profile_torch_solve.py
        [--problem poisson|unfaced|diffusion|poisson2d] [--n N] [--out DIR]
        [--levels] [--root DIR] [--leg-depth-27 D] [--warm W]
        [--residual-dtype doublefloat|float32] [--krylov none|pcg]
        [--krylov-iters K] [--cycle-type v|w|f]
        [--smoother rbgs|jacobi|chebyshev] [--setup host|device]

Sets up a solve of ``chip_smoke.py`` (V(2,2) red-black, linear transfers,
double-float outer loop, or with ``--residual-dtype float32`` the float32
outer residual of one K3 pass a cycle and a threshold of 1e-5 (2D: 2e-5),
dense coarsest level of at most 4096 points; ``--cycle-type`` w or f runs
W or FMG cycles, ``--krylov pcg`` runs ``--krylov-iters`` (default 2)
MG-preconditioned CG steps an outer step; ``--smoother`` chebyshev runs
the 4th-kind Chebyshev smoother, one per-pass residual launch of K3 or K4
an iteration):
``poisson`` on n³ from the grid shape (fused level visits, the double-float
update kernel), ``unfaced`` the same with ``setup(..., faced=False)`` (its
27-point levels as coefficient grids, visited by K4's legs), ``diffusion``
on n³ from the stencil pair of a random medium
(K4's legs on varying levels, the general double-float residual in
tensor code), or ``poisson2d`` on n² from the grid shape (the whole-visit 2D
kernel, the lifted double-float update kernel).  n defaults to 256 in 3D and
4096 in 2D.  Runs it once to warm up, ``W`` times more (default 5) for
the warm wall times, then once under ``torch.profiler`` and prints one
JSON line: the card's name and power limit, the solves' wall times, the
device time summed by kernel name, and the device's busy and idle share
of the profiled solve.  ``--leg-depth-27 D`` makes a leg of a 27-point
varying level take launches of up to D levels (``kernels.leg_depth``;
1 is a pass a launch) on every level, in place of the package's rule.  With ``--out`` the Chrome
trace is written there.  With ``--levels`` (``poisson`` and ``poisson2d``)
it also times the fused level visits of the solve's hierarchy one by one:
on every visited level the down-leg (zero start, the stages, the
restricted residual) and the up-leg (``x + P·ec``, the stages), and in 3D
on the finest level a visit of 6 and one of 50 Jacobi stages (``bench.py``'s
sweep, in as many launches as the port takes), each as device milliseconds
a visit, 20 visits back to back (2D: one call of ``fused._fused2d``, the
V-cycle's kernel call, a visit).  ``--root`` profiles the package of another checkout
(an earlier commit unpacked with ``git archive``), so two versions are
timed by the same script.  ``--setup device`` builds the hierarchy of
``poisson`` or ``diffusion`` with ``build_hierarchy_device`` (the Galerkin
chain as tensor code on the card) instead of the host chain, and profiles
that build too (``setup_profile``: device time by kernel, busy ms, peak
memory).  Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv[:-1]:
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
sys.path.insert(0, ROOT)


def device_ms(fn, reps=20):
    """Device milliseconds a call, ``reps`` calls back to back; the card is
    held busy while they are enqueued, so the host's cost of a call does
    not count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_s, 5.0) * 2e9))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def level_visits(hierarchy, dev):
    """Device ms of each fused level visit of the hierarchy (see above)."""
    from openmg_tpu_torch.ops import fused

    tr = hierarchy.transfer
    rb4 = fused.stages_for("rbgs", 2, 2 / 3)
    out = {}
    for i, L in enumerate(hierarchy.levels[:-1]):
        op, shape = L.A, L.grid_shape
        corner = fused._corner_info(op)
        rng = np.random.default_rng(i)
        b, x = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                for _ in range(2))
        ec = torch.from_numpy(rng.standard_normal(tuple(s // 2 for s in shape))
                              .astype(np.float32)).to(dev)

        def visit(stages, xx=None, **kw):
            return lambda: fused.fused_stages_const_3d(
                op.values, op.offsets, b, xx, stages, corner=corner, **kw)

        cases = {
            "down": visit(rb4, emit_residual=True, restrict_transfer=tr),
            "up": visit(rb4, x, ec=ec, prolong_transfer=tr),
        }
        if i == 0:
            for n in (6, 50):
                cases[f"jacobi{n}"] = visit(fused.stages_for("jacobi", n, 2 / 3), x)
        for name, fn in cases.items():
            out[f"{'x'.join(map(str, shape))} {name}"] = device_ms(fn)
        del b, x, ec
    return out


def level_visits_2d(hierarchy, dev):
    """Device ms of each 2D level visit of the hierarchy: on every visited
    level the down-leg (zero start, four red/black stages, the restricted
    residual) and the up-leg (``x + P·ec``, four red/black stages), each one
    call of ``fused._fused2d`` (the V-cycle's kernel call), 20 visits back
    to back."""
    from openmg_tpu_torch.ops import fused

    tr = hierarchy.transfer
    out = {}
    for i, L in enumerate(hierarchy.levels[:-1]):
        op, shape = L.A, L.grid_shape
        rng = np.random.default_rng(i)
        b, x = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                for _ in range(2))
        ec = torch.from_numpy(rng.standard_normal(tuple(s // 2 for s in shape))
                              .astype(np.float32)).to(dev)
        cases = {
            "down": lambda: fused._fused2d("rbgs", op, b, None, 2, 2 / 3, True,
                                           restrict_transfer=tr),
            "up": lambda: fused._fused2d("rbgs", op, b, x, 2, 2 / 3, False,
                                         ec=ec, prolong_transfer=tr),
        }
        for name, fn in cases.items():
            out[f"{'x'.join(map(str, shape))} {name}"] = device_ms(fn)
        del b, x, ec
    return out


def device_setup(problem_name, problem, cfg):
    """``build_hierarchy_device`` of the problem on the card, once to warm
    up and once under ``torch.profiler``: (seconds, profile, hierarchy)."""
    from torch.profiler import ProfilerActivity, profile

    from openmg_tpu_torch.core.hierarchy import build_hierarchy_device
    from openmg_tpu_torch.models.poisson import poisson_offsets
    from openmg_tpu_torch.ops.transfer import TRANSFERS

    kw = dict(transfer=TRANSFERS[cfg.transfer],
              max_dense_coarse=cfg.max_dense_coarse, device="cuda")
    if problem_name == "poisson":
        kw.update(offsets=poisson_offsets(3), fine_values=[6.0] + [-1.0] * 6,
                  shape=problem)
    else:
        kw.update(offsets=problem[0], coeffs=problem[1])
    build_hierarchy_device(**kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        h = build_hierarchy_device(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or getattr(
            ev, "self_cuda_time_total", 0)
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            row = by_kernel.setdefault(ev.key[:70], {"ms": 0.0, "count": 0})
            row["ms"] += dev_us / 1e3
            row["count"] += ev.count
    busy = sum(v["ms"] for v in by_kernel.values())
    return wall, {
        "setup_s_profiled": wall, "device_busy_ms": busy,
        "device_operations": sum(v["count"] for v in by_kernel.values()),
        "peak_memory_MB": torch.cuda.max_memory_allocated() / 2 ** 20,
        "kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]["ms"])[:12]),
    }, h


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem",
                    choices=("poisson", "unfaced", "diffusion", "poisson2d"),
                    default="poisson")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--levels", action="store_true")
    ap.add_argument("--root", default=None)
    ap.add_argument("--leg-depth-27", type=int, default=None)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--residual-dtype", choices=("doublefloat", "float32"),
                    default="doublefloat")
    ap.add_argument("--krylov", choices=("none", "pcg"), default="none")
    ap.add_argument("--krylov-iters", type=int, default=2)
    ap.add_argument("--cycle-type", choices=("v", "w", "f"), default="v")
    ap.add_argument("--smoother", choices=("rbgs", "jacobi", "chebyshev"),
                    default="rbgs")
    ap.add_argument("--setup", choices=("host", "device"), default="host")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import kernels
    from torch.profiler import ProfilerActivity, profile

    if args.leg_depth_27 is not None:
        own = kernels.leg_depth
        kernels.leg_depth = lambda taps, points: (
            args.leg_depth_27 if taps == 27 else own(taps, points))

    if args.problem == "poisson2d":
        shape = (args.n or 4096,) * 2
    else:
        shape = (args.n or 256,) * 3
    # a float32 outer residual stalls near 1e-5 with ‖b‖₂ = 1 (2e-5 in 2D)
    f32 = args.residual_dtype == "float32"
    cfg = mg.SolverConfig(
        smoother=args.smoother, transfer="linear",
        residual_dtype=args.residual_dtype,
        max_dense_coarse=4096, cycles=60, krylov=args.krylov,
        krylov_iters=args.krylov_iters, cycle_type=args.cycle_type,
        **({"threshold": 2e-5 if args.problem == "poisson2d" else 1e-5}
           if f32 else {}),
    )
    if args.problem == "diffusion":
        kappa = 0.5 + np.random.default_rng(12).random(shape)
        problem = mg.diffusion_stencil(kappa)
    else:
        problem = shape
    setup_profile = None
    t0 = time.perf_counter()
    if args.setup == "device":
        if args.problem not in ("poisson", "diffusion"):
            ap.error("--setup device takes --problem poisson or diffusion")
        setup_s, setup_profile, hierarchy = device_setup(args.problem, problem, cfg)
        solver = mg.Solver(hierarchy, cfg)
    elif args.problem == "unfaced":
        solver = mg.setup(problem, cfg, faced=False)
    else:
        solver = mg.setup(problem, cfg)
    torch.cuda.synchronize()
    if args.setup == "host":
        setup_s = time.perf_counter() - t0
    del problem
    bnp = mg.rhs_random(shape, seed=1)
    bnp /= np.linalg.norm(bnp.ravel())
    b = torch.from_numpy(bnp.astype(np.float32)).cuda()
    solver.solve(b)
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.warm):
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = solver.solve(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or getattr(
            ev, "self_cuda_time_total", 0)
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            # names are cut to 70 characters; kernels that then share a name
            # (PyTorch's elementwise kernels by functor) are summed
            row = by_kernel.setdefault(ev.key[:70], {"ms": 0.0, "count": 0})
            row["ms"] += dev_us / 1e3
            row["count"] += ev.count
    busy = sum(v["ms"] for v in by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]["ms"])[:16])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(args.out, f"solve_{args.problem}_{shape[0]}.json"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "problem": args.problem, "residual_dtype": args.residual_dtype,
        "smoother": args.smoother, "setup": args.setup,
        "setup_profile": setup_profile,
        "krylov": args.krylov, "krylov_iters": args.krylov_iters,
        "cycle_type": args.cycle_type,
        "shape": list(shape), "cycles": info["cycles"], "setup_s": setup_s,
        "launches_profiled": sum(v["count"] for v in by_kernel.values()),
        "launches_per_outer_step": {
            k: v["count"] / max(info["cycles"], 1) for k, v in top.items()},
        "solve_ms_unprofiled": walls,
        "leg_depth_27": args.leg_depth_27,
        "residual": info.get("final_norm"),
        "solve_ms_profiled": wall * 1e3,
        "device_busy_ms": busy,
        "device_idle_share_of_profiled_solve": max(0.0, 1.0 - busy / (wall * 1e3)),
        "device_idle_share_of_median_warm_solve": max(
            0.0, 1.0 - busy / float(np.median(walls))) if walls else None,
        "kernels": top,
        "root": ROOT,
        "level_visits_device_ms": (
            None if not args.levels
            else level_visits(solver.hierarchy, b.device)
            if args.problem == "poisson"
            else level_visits_2d(solver.hierarchy, b.device)
            if args.problem == "poisson2d" else None),
    }))


if __name__ == "__main__":
    main()
