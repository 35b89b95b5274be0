#!/usr/bin/env python3
"""K4's legs on the card, in every launch policy: device time, host time a
launch, and the error against the plain loop of passes.

    python3 scripts/bench_vary_leg.py [--n N] [--root DIR] [--reps R]

Builds the levels of ``chip_smoke.py``'s 256³ diffusion hierarchy (7 taps on
n³, 27 on (n/2)³) and of the 256³ Poisson hierarchy with ``faced=False``
(27 taps on (n/2)³ and (n/4)³), and on each runs the legs a V(2,2) visit takes (a
down-leg of four red/black passes from zero and the residual, an up-leg of
four from x, and the Jacobi legs of two) through
``kernels.sweeps_vary_3d`` under each policy: the most levels a launch
takes (``leg_depth``: 1 is a pass a launch of ``csrc/half_sweep.cu``) and
whether a launch of two levels reads its coefficients from the kernel's
shared-memory ring (``leg_ring``; here in either mode).  The policies are set by
replacing those two functions.  Per row: device milliseconds a leg (CUDA
events over ``reps`` legs back to back, the card held busy while they are
enqueued), host microseconds a launch (the wall time of enqueuing them
over the launches), the launches, and the largest error of x (and r)
against ``sweeps_vary_plain`` with its bound ``2e-6·max|ref|``.
``--root`` runs the package of another checkout (an earlier commit
unpacked with ``git archive``) with its own policy, so two versions are
timed by one script.  Prints one JSON line; needs a CUDA device.
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
LEGS = (
    # (name, start from x?, passes, mode, residual)
    ("down", False, 4, "rbgs", True),
    ("up", True, 4, "rbgs", False),
    ("jacobi down", False, 2, "jacobi", True),
    ("jacobi up", True, 2, "jacobi", False),
)


def timed(fn, reps):
    """(device ms a call, host µs a call): ``reps`` calls back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # keep the card busy while the calls are enqueued: the host's time is
    # then its own, and the events see the device's
    torch.cuda._sleep(int(min(2 * host_s + 0.05, 5.0) * 2e9))
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, host_us


def policies(kernels, taps):
    """(name, leg_depth, leg_ring) to run on this tree at ``taps``."""
    own = [("own", kernels.leg_depth, getattr(kernels, "leg_ring", None))]
    if not hasattr(kernels, "leg_ring"):
        return own
    out = own + [("a pass a launch", lambda t, p: 1, lambda t, d, m: False)]
    for depth in (2, 3):
        out.append((f"depth {depth}", lambda t, p, d=depth: d,
                    lambda t, d, m: False))
        if taps <= kernels.RING_MAX_TAPS:
            out.append((f"depth {depth}, ring at depth 2",
                        lambda t, p, d=depth: d, lambda t, d, m: d == 2))
    return out


def run_level(tag, op, inv, reps):
    from openmg_tpu_torch.ops import kernels

    dev = op.coeffs.device
    shape = op.grid_shape
    K = len(op.offsets)
    g = torch.Generator(device="cpu").manual_seed(31)
    b = torch.randn(shape, generator=g).to(dev)
    x0 = torch.randn(shape, generator=g).to(dev)
    rows = []
    real = (kernels.leg_depth, getattr(kernels, "leg_ring", None))
    for pname, depth_fn, ring_fn in policies(kernels, K):
        kernels.leg_depth = depth_fn
        if ring_fn is not None:
            kernels.leg_ring = ring_fn
        try:
            for leg, from_x, passes, mode, res in LEGS:
                x = x0 if from_x else None

                def run(x=x, passes=passes, mode=mode, res=res):
                    return kernels.sweeps_vary_3d(
                        op.coeffs, op.offsets, b, x, passes, mode, OMEGA,
                        emit_residual=res, inv_diag=inv)

                before = kernels.LAUNCHES_K4
                got = run()
                torch.cuda.synchronize()
                launches = kernels.LAUNCHES_K4 - before
                ref = kernels.sweeps_vary_plain(
                    op.coeffs, op.offsets, b, x, passes, mode, OMEGA, res,
                    inv_diag=inv)
                got, ref = (got, ref) if res else ((got,), (ref,))
                errs = {}
                for what, gg, rr in zip("xr", got, ref):
                    scale = float((b if what == "r" else rr).abs().max())
                    err = float((gg - rr).abs().max())
                    errs[what] = [err, TOL * scale]
                    if not err <= TOL * scale:
                        raise SystemExit(f"{tag} {pname} {leg} {what}: err "
                                         f"{err:.3e} > {TOL * scale:.3e}")
                del got, ref
                ms, host_us = timed(run, reps)
                rows.append({"level": tag, "taps": K, "policy": pname,
                             "leg": leg, "launches": launches, "ms": ms,
                             "host_us_per_launch": host_us / launches,
                             "max_abs_err": errs})
        finally:
            kernels.leg_depth = real[0]
            if real[1] is not None:
                kernels.leg_ring = real[1]
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    import openmg_tpu_torch as mg

    dev = torch.device("cuda")
    shape = (args.n,) * 3
    cfg = mg.SolverConfig(smoother="rbgs", transfer="linear",
                          residual_dtype="doublefloat", max_dense_coarse=4096)
    kappa = 0.5 + np.random.default_rng(12).random(shape)
    hv = mg.setup(mg.diffusion_stencil(kappa), cfg, device=dev).hierarchy
    del kappa
    rows = []
    for i in (0, 1):
        L = hv.levels[i]
        rows += run_level(f"diffusion {'x'.join(map(str, L.grid_shape))}",
                          L.A, L.inv_diag, args.reps)
    del hv
    torch.cuda.empty_cache()
    hu = mg.setup(shape, cfg, device=dev, faced=False).hierarchy
    for i in (1, 2):
        L = hu.levels[i]
        rows += run_level(f"unfaced {'x'.join(map(str, L.grid_shape))}",
                          L.A, L.inv_diag, args.reps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "root": ROOT, "rows": rows}))


if __name__ == "__main__":
    main()
