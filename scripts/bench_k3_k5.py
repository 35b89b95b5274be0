#!/usr/bin/env python3
"""K5 (the 2D level visit) and K3 (the constant 3D pass) on the card: device
time a call on the solves' levels, with its bound and its error against the
plain version.

    python3 scripts/bench_k3_k5.py [--root DIR] [--reps R]
        [--k5-rows N ...] [--k3-planes N ...] [--only k3|k5]

K5: on every visited level of the 4096² Poisson hierarchy (4096²
constant 5-point, 2048² to 128² cornered 9-point), the down-leg (zero
start, four red/black stages, the restricted residual) and the up-leg
(``x + P·ec``, four red/black stages) that a V(2,2) cycle launches, through
``kernels.fused_stages_2d``.  K3: Jacobi, both red/black colours and the
residual through ``kernels._half_sweep`` on the 256³ 7-point level and the
128³ cornered 27-point level of the 256³ hierarchy, and the residual on the
1024² 2D level lifted to ``(1, ny, nx)`` (the 1024² float32-residual solve's
pass).  Each row: device milliseconds a call (CUDA events over ``reps``
calls back to back, the card held busy while they are enqueued), the bound
(bytes each input read once and each output written once, over 3.35 TB/s),
launches a call, and the largest error against the plain version with its
tolerance ``2e-6·max|ref|`` (a residual: ``2e-6·max|b|``).

``--k5-rows`` / ``--k3-planes`` time the kernels again with other plans
(rows a warp marches; planes a block marches), set through
``kernels.K5_ROWS`` / ``kernels.K3_PLANES``; trees without those plans
ignore them.  ``--root`` runs the package of another checkout (an earlier
commit unpacked with ``git archive``), so two versions are timed by one
script.  Prints one JSON line; needs a CUDA device.
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

OMEGA = 2.0 / 3.0
TOL = 2e-6
PEAK_BYTES_PER_S = 3.35e12
CFG = dict(smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
           max_dense_coarse=4096)


def device_ms(fn, reps):
    """Device milliseconds a call, ``reps`` calls back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_s + 0.05, 5.0) * 2e9))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def randn(shape, seed, dev):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev)


def error(got, ref, b, outs):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    worst, ok = 0.0, True
    for name, g, r in zip(outs, got, ref):
        err = float((g - r).abs().max())
        tol = TOL * float((b if name == "r" else r).abs().max())
        ok = ok and bool(torch.isfinite(g).all()) and err <= tol
        worst = max(worst, err / tol)
    return worst, ok


def k5_rows(dev, reps):
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import fused, kernels

    h = mg.setup((4096, 4096), mg.SolverConfig(**CFG), device=dev).hierarchy
    tr = h.transfer
    rb4 = fused.stages_for("rbgs", 2, OMEGA)
    out = []
    for L in h.levels[:-1]:
        op = L.A
        shape = L.grid_shape
        n = int(np.prod(shape))
        nc = n // 4
        corner = fused._corner_info(op)
        b, x = randn(shape, 1, dev), randn(shape, 2, dev)
        ec = randn(tuple(s // 2 for s in shape), 3, dev)
        legs = {
            "down": (lambda impl: impl(op.values, op.offsets, b, None, rb4,
                                       corner=corner, emit_residual=True,
                                       restrict_transfer=tr),
                     ("x", "r"), 4 * (2 * n + nc)),
            "up": (lambda impl: impl(op.values, op.offsets, b, x, rb4,
                                     corner=corner, ec=ec, prolong_transfer=tr),
                   ("x",), 4 * (3 * n + nc)),
        }
        for leg, (call, outs, nbytes) in legs.items():
            before = kernels.LAUNCHES_K5
            got = call(kernels.fused_stages_2d)
            torch.cuda.synchronize()
            launches = kernels.LAUNCHES_K5 - before
            err, ok = error(got, call(kernels.fused_stages_2d_plain), b, outs)
            del got
            out.append({
                "level": "x".join(map(str, shape)), "leg": leg,
                "taps": len(op.offsets), "launches": launches,
                "ms": device_ms(lambda: call(kernels.fused_stages_2d), reps),
                "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                "err_over_tol": err, "ok": ok,
            })
        del b, x, ec
    return out


def k3_rows(dev, reps):
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import fused, kernels

    h3 = mg.setup((256,) * 3, mg.SolverConfig(**CFG), device=dev).hierarchy
    h2 = mg.setup((1024, 1024), mg.SolverConfig(**CFG), device=dev).hierarchy
    cases = [
        (h3.levels[0].A, False, ("jacobi", "rb0", "rb1", "residual")),
        (h3.levels[1].A, False, ("jacobi", "rb0", "rb1", "residual")),
        (h2.levels[0].A, True, ("residual",)),
    ]
    out = []
    for op, lift, modes in cases:
        shape = op.grid_shape
        n = int(np.prod(shape))
        offs = kernels._lift2d(op.offsets) if lift else op.offsets
        corner = fused._corner_info(op)
        if lift:
            corner = kernels._lift_corner(corner)
        s3 = (1,) + tuple(shape) if lift else tuple(shape)
        b, x = randn(s3, 11, dev), randn(s3, 12, dev)
        for name in modes:
            mode = "rbgs" if name.startswith("rb") else name
            color = int(name[2]) if name.startswith("rb") else 0

            def run(impl, mode=mode, color=color):
                if impl is None:
                    return kernels._half_sweep(op.values, b, x, offsets=offs,
                                               mode=mode, omega=OMEGA,
                                               color=color, corner=corner)
                return impl(op.values, offs, b, x, mode, OMEGA, color, corner)

            before = kernels.LAUNCHES_K3
            got = run(None)
            torch.cuda.synchronize()
            launches = kernels.LAUNCHES_K3 - before
            err, ok = error(got, run(kernels.half_sweep_plain), b,
                            ("r",) if mode == "residual" else ("x",))
            del got
            # one colour: b at its points, x at the other colour's (and its
            # own where taps couple one colour), out everywhere
            same = any(sum(o) % 2 == 0 and any(o) for o in offs)
            nbytes = 12 * n if mode != "rbgs" else (
                4 * n + (4 * n if same else 2 * n) + 2 * n)
            out.append({
                "level": "x".join(map(str, shape)), "mode": name,
                "taps": len(offs), "launches": launches,
                "ms": device_ms(lambda: run(None), reps),
                "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                "err_over_tol": err, "ok": ok,
            })
        del b, x
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--k5-rows", type=int, nargs="*", default=[])
    ap.add_argument("--k3-planes", type=int, nargs="*", default=[])
    ap.add_argument("--only", choices=("k3", "k5"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    from openmg_tpu_torch import _build
    from openmg_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    res = {"root": ROOT, "build_s": build_s,
           "ptxas": [ln.strip() for ln in _build.info.get("log", "").splitlines()
                     if "spill" in ln and "0 bytes spill" not in ln][:40]}
    if args.only != "k3":
        res["k5"] = {"own": k5_rows(dev, args.reps)}
        if hasattr(kernels, "K5_ROWS"):
            own = kernels.K5_ROWS
            for r in args.k5_rows:
                kernels.K5_ROWS = (r,)
                res["k5"][f"rows {r}"] = k5_rows(dev, args.reps)
            kernels.K5_ROWS = own
    if args.only != "k5":
        res["k3"] = {"own": k3_rows(dev, args.reps)}
        if hasattr(kernels, "K3_PLANES"):
            own = kernels.K3_PLANES, kernels.K3_BLOCKS_PER_SM
            for z in args.k3_planes:
                kernels.K3_PLANES, kernels.K3_BLOCKS_PER_SM = z, 0
                res["k3"][f"planes {z}"] = k3_rows(dev, args.reps)
            kernels.K3_PLANES, kernels.K3_BLOCKS_PER_SM = own
    res["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
