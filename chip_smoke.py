#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Drives ``openmg_tpu_torch`` through the entry points a user calls, on the
card, and fails (non-zero exit, no result line) if any phase fails:

1. ``env``     versions, the card's name and power limit, and the measured
               device-to-device copy bandwidth;
2. ``build``   builds the CUDA kernels from ``openmg_tpu_torch/csrc``;
3. ``kernels`` holds the fused level-visit kernel (K1) and the double-float
               outer step (K2) against their plain PyTorch versions on the
               card, in every mode the V-cycle uses, on every visited level
               of the 256³ hierarchy (the constant 256³ level, the cornered
               27-point 128³, 64³ and 32³ levels), at shapes whose dims are
               not multiples of 32 and on a 19-point stencil (the kernel's
               generic tap count), and times both; a visit of 14 Jacobi
               stages, deeper than one launch takes, must be
               ⌈14 / MAX_DEPTH⌉ launches;
3a. ``batch_kernels`` the batched forms at K = 8 (the reference's kernels
               under ``jax.vmap``): K1b's down-leg, up-leg with ``ec``,
               residual with restriction and down-leg from x on 256³ and on
               the cornered 128³, 64³ and 32³ levels (the shape it took,
               resident or marching, beside the scalar launch's), K2b on
               256³ and on the 4096² lift, K5b's down-leg and up-leg on
               4096² and the cornered 2048² and 256² levels; each held
               against its batched plain version with the scalar kernel's
               tolerance (K2b bit for bit) and against K launches of the
               scalar kernel, bit for bit member by member; device ms of
               one batched launch beside K scalar launches and K × the
               scalar bound;
4. ``solve``   the 3D Poisson 256³ defect-correction solve (five levels,
               V(2,2) red-black, linear transfers, double-float outer loop)
               from a float32 tensor on the card, checked in float64 on the
               host; the same solve under ``torch.profiler``, whose count
               of K1 launches on the device must be one a level visit (56
               in 7 cycles) and equal ``fused.LAUNCHES``, with its
               breakdown by kernel on a line of its own (``solve_profile``);
               a small solve against the same solve run on the CPU;
               a numpy-float64 solve through ``mg_solve``; a V(2,0) cycle
               against the CPU; and a float64 cycle, which the card must
               refuse instead of running plain tensor code;
4a. ``solve_512`` the solve of ``solve`` at 512³ (six levels; K1 on a
               cornered 27-point level of 256² planes): at most 9 cycles to
               ‖r‖₂ < 1e-10, one K1 launch a leg, one K2 launch a cycle, no
               K3 launch, checked in float64 on the host, with its setup
               time, warm solve time and peak memory;
5. ``fused2d`` holds the whole-visit 2D stage fusion (K5) against its plain
               version on the card in every mode the V-cycle uses (down-leg
               with restriction, up-leg with prolongation, stages on x, zero
               start with the residual; red/black and Jacobi) on every
               visited level of the 4096² hierarchy (constant 4096²,
               cornered 2048² to 128²), at (200,328) and (100,164), and
               without transfers at (37,91); times every mode at 4096² and
               the down-leg and up-leg on every cornered level, with
               ``F.conv2d`` beside the residual mode as a yardstick (the
               port never calls it); K2 on a 4096² grid (the lift to
               (1, ny, nx)) bit for bit; K3's residual on the cornered
               2048² level against the CPU;
6. ``solve_2d`` the 2D Poisson 4096² solve (seven levels, V(2,2) red-black,
               linear transfers, double-float outer loop: two K5 launches a
               visited level and one K2 launch a cycle, nothing else),
               checked in float64 on the host; BASELINE config 2 (256²,
               five levels) on the card against the CPU; ``mg_solve`` with
               the scipy matrix of a 512² Poisson problem (K5 + K2 on the
               constant fine level, K4 lifted on the varying coarse ones);
               a (256,512) diffusion stencil pair against the CPU; a 1024²
               solve with a float32 outer residual; ``residual`` /
               ``smooth`` with CUDA tensors on a cornered 2D operator; and a
               1D ``setup``, which lands on the card (its solves: 7b);
7. ``solve_unfaced`` the 256³ Poisson solve of ``solve`` on the
               hierarchy of ``setup(..., faced=False)``: the constant fine
               level by K1 and K2, the three varying 27-point coarse levels
               by K4 legs and no K1 there, the same cycle count as the
               faced solve, a float64 residual below 1e-10, with its setup
               time and peak memory;
7a. ``faced``  the 128³, 64³ and 32³ levels of that hierarchy as
               ``FacedStencilOperator``s (``detect_faced`` on their grids):
               ``apply``, ``residual`` and one Jacobi and one red/black
               ``smooth`` on the card (K3's constant passes and tensor face
               rows: 0, 1, 1, 2 K3 launches) against the varying operator
               on the card (K4 passes) and against the faced operator's
               plain version on the CPU, within 1e-5 absolute or 2e-6 ·
               max|ref| (tests/test_faced.py's tolerance); then the 256³
               solve on the hierarchy with those faced levels: the faced
               solve's cycle count, 2 K1, 1 K2 and 9 K3 a faced level a
               cycle;
7b. ``solve_1d`` 1D grids on the ``(1, 1, n)`` lift (K3 passes, K2, the
               tensor transfers): BASELINE config 1 (N = 64, two levels,
               Jacobi V(2,2), ``tests/test_solver.py``'s right-hand side)
               and N = 256 at full depth (red/black and Jacobi) on the card
               against the CPU, equal cycle counts, exact launch counts;
               K3 on every visited level of the lift (constant, cornered
               3-point) against its plain version (2e-6 · max|ref|, or
               max|b| for a residual) and K2 on the lift bit for bit; a
               float64 cycle refused at setup;
8. ``sweeps``  as ``kernels``, for the per-pass kernel with constant or
               cornered taps (K3) and with per-point coefficient grids (K4,
               on the diffusion hierarchy set up just before it): Jacobi,
               both red/black colours and the residual, at 256³ with 7
               taps, at 128³ with 27 taps, at (20,36,72) and on a 2D
               operand lifted to (1, ny, nx); ``F.conv3d`` is timed beside
               K3's residual as a yardstick (the port never calls it); and
               K4's legs (``sweeps_vary_3d``, ``K4_legs``: a down-leg of
               four red/black passes from zero and the residual, an up-leg
               of four from x, and the two Jacobi legs) on every varying
               level of the diffusion hierarchy, the odd shape, the 2D lift
               and the unfaced 27-point levels, each in the launches of
               ``kernels.leg_chunks`` at the level's ``kernels.leg_depth``
               (a Jacobi launch of two levels reads its coefficients from
               the kernel's shared-memory ring, ``kernels.leg_ring``); at
               256³ and 128³ timed beside the same passes one launch each;
9. ``solve_vary`` the 256³ variable-coefficient diffusion solve from a
               stencil pair (host Galerkin chain, four varying levels, every
               level visit two K4 legs, the general double-float
               residual), checked in float64 on the host; the (32,32,64)
               diffusion solve against the CPU; ``mg_solve`` with a scipy
               Poisson matrix; the 256³ Poisson solve with a float32 outer
               residual (one K3 launch per residual); and ``residual`` /
               ``smooth`` called with CUDA tensors on a constant, a cornered
               and a varying operator;
10. ``spmv``   holds the slot-offset ELL SpMV (K6) and the blocked-band BSR
               SpMV (K7; both ``csrc/spmv_banded.cu``, K6 at block size 1)
               against their plain versions on the card: K6 on every visited
               level of the 1024² Poisson ELL hierarchy (k 5, then three
               k-9 levels), on the 256³ Poisson ELL of ``poisson_ell_device``,
               on (37, 91) (n not a multiple of 32), with two pad slots and in
               float64; K7 on every visited level of the 64³
               coupled-diffusion B=4 hierarchy (kb 7, then two kb-27
               levels), on 2D elasticity 256² (B=2), 3D elasticity 24³
               (B=3), Poisson 16³ at B=8 and in float64; times each beside
               ``torch.mv`` on a ``torch.sparse`` CSR of the true nonzeros
               (a yardstick the port never calls) and prints the ratio
               (``ms_over_library``);
11. ``solve_sparse`` the 64³ coupled-diffusion B=4 solve through
               ``setup_sparse`` (BSR, Jacobi, linear transfers: five K7
               launches a visited level a cycle) and the 1024² Poisson solve
               through ``mg_solve`` with ``format="ell"`` (red/black by
               colour classes: 1 + 4·colours K6 launches a visited level a
               cycle), each from a float32 tensor and checked in float64 on
               the host with the scipy matrix; ELL 128², BSR coupled
               diffusion 16³ (B=4) and 2D elasticity 128² (B=2, both
               formats, the settings of ``scripts/probe_bsr_chip.py``, whose
               run took 22 cycles) on the card against the CPU; the ELL
               engine against the stencil engine at 1024² (Jacobi, aggregate
               transfers, first ten residual norms); and the BSR solve with
               ``krylov="pcg"`` (K7 also for ``A p``) and the ELL solve with
               ``cycle_type="f"`` through ``mg_solve`` (keys ``pcg``,
               ``fmg``);
12. ``solve_cycles`` (after ``solve_2d``) the 256³ Poisson solve with W
               and FMG cycles and the 4096² one with FMG (every level visit
               two launches of K1 or K5, one K2 launch an outer step), and
               the (32, 32, 64) solve with W, FMG and PCG(2) on the card
               against the CPU;
8a. ``batch_kernels_k3k4`` (after ``sweeps``) K3b and K4b at K = 8 on
               the hierarchies of ``sweeps``: K3b's Jacobi, colour-1 and
               residual passes on the constant 256³ and the cornered 128³
               Poisson levels (``F.conv3d`` with batch K beside the
               residual as a yardstick), K4b's down-leg and up-leg on the
               256³ (7 taps) and 128³ (27 taps) diffusion levels and one
               K4b residual pass on 256³; each as ``batch_kernels`` holds
               its cases, the bound the coefficient grids once and K × the
               members' fields;
8b. ``solve_many_stack`` (after ``batch_kernels_k3k4``) ``solve_many`` at
               K = 8 where the batch needs K3b or K4b: the 256³ diffusion
               solve (K4b legs), the 256³ Poisson solve with
               ``faced=False`` (K1b, K2b, K4b), with Chebyshev (K3b, K2b)
               and with a float32 outer residual (K1b, K3b), and (64, 64,
               128) on faced levels (K1b, K2b, K3b); the checks of
               ``solve_many``, no scalar launch of any kernel;
10a. ``batch_kernels_k6k7`` (after ``spmv``) K6b on the 1024² ELL levels 0
               (k 5) and 1 (k 9), K7b on the 64³ B=4 levels 0 (kb 7) and
               1 (kb 27), K = 8: bit for bit against the batched plain
               version and against K scalar launches, device ms on
               rotating operand copies beside K scalar launches and
               ``torch.sparse.mm`` with an ``(n, K)`` block;
13. ``solve_many`` ``Solver.solve_many`` at 256³, at (64, 64, 128) and
               at 4096², K=8 (seeds 1-8): one K1b (K5b in 2D) launch a
               level visit and one K2b launch an outer step for the whole
               batch, no scalar K1, K2 or K5 launch; each member's cycles
               and pair bit-equal to its scalar solve on the card, one host
               read of the batch's norms a step (the loop's count and the
               profiler's count of device-to-host copies), ms per
               right-hand side beside the scalar solve's, peak memory, and
               from numpy input;
14. ``solve_pcg`` (after ``solve_vary``) the 256³ Poisson, 4096² Poisson
               and 256³ diffusion solves with ``krylov="pcg",
               krylov_iters=2`` (K1, K5 or K4 legs, two cycles an outer
               step), beside the JAX package's record of 3 outer steps at
               256³;
14a. ``solve_cheb`` (after ``solve_pcg``) Chebyshev smoothing (a cycle
               limit of 60): the 256³ Poisson solve on the ``faced=True``
               hierarchy (pre + post + 1 = 5 K3 launches a visited level a
               cycle, 1 K2, no K1; one host read a step by the profiler's
               device-to-host copies; a breakdown by kernel and the share of
               the tensor code), the 256³ diffusion solve (5 K4 passes a
               visited level), the 4096² solve (K3 on the 2D lift), and
               (32, 32, 64) on the card against the CPU (equal counts,
               ‖Δx‖₂ ≤ 2e-10/λ_min);
14b. ``setup_device`` ``build_hierarchy_device`` on the card for the
               256³ diffusion coefficients and for 256³ Poisson
               (``fine_values``): setup seconds beside the host Galerkin
               chain's in this run, every level's offsets equal to the
               host chain's and its coefficients and inverse diagonal
               within 1e-5 · max|host| (float32 chains; for diffusion also
               within 1e-5 relative of the float64 host chain's values cast
               to float32, the rounding of the same sums), the build's peak
               memory, and a solve on each with the host-built hierarchy's
               cycle count (diffusion: K4 legs; Poisson: K1 and K2 on the
               constant fine level, K4 legs on the varying ones);
15. ``solve_many_sparse`` ``AlgebraicSolver.solve_many`` on the 1024² ELL
               and the 64³ B=4 BSR hierarchies, K=4, with the checks of
               ``solve_many``: one K6b or K7b launch a product of the stack,
               no scalar K6 or K7;
14c. ``halo_kernels`` (after ``setup_device``) the halo forms of K1–K4 on
               the 256³ hierarchy cut into 4 z-slabs, each slab's planes
               cut from its neighbours (zeros at the domain edges): K3 in
               every mode on 256³ and on the cornered 128³ level, K4 one
               pass on the 256³ diffusion grids, K2 on 256³, K1's down-leg,
               up-leg with ``ec`` and residual with restriction on 256³
               and 128³; each slab held against the form's plain version
               (the tolerances below; K2 bit for bit) and the slabs
               together against the whole-grid kernel's rows; device ms
               of an inner slab beside the whole grid's ms / 4 and the
               slab's bound;
16. ``solve_dist`` the 256³ Poisson solve of ``solve`` on P = 2 and P = 4
               ranks, each a process of this script (``--dist-rank``) on
               the one card, gloo with the planes staged through the host;
               PCG(2) on a (2, 2) mesh; the 128³ diffusion solve on 2
               ranks (K4's halo form); one NCCL rank with every level
               partitioned (``force_partition``): the single-device
               cycles, ‖x_dist − x_single‖₂ ≤ 2e-10/λ_min against the
               single-device solve on the card, launches by kernel on rank
               0, halo bytes a cycle, warm ms (one card shared by P ranks:
               not a scaling figure); any rank's failure fails the script;
               every solve's bytes sent, staged and gathered equal to the
               communication model's (``parallel/model.py``) for it;
17. ``solve_sparse_dist`` (its ranks are those of ``solve_dist``) the
               1024² ELL solve of ``solve_sparse`` on the distributed
               general-sparse engine: V(2,2) red/black on P = 2 and P = 4
               gloo ranks, PCG(2) on a (2, 2) mesh, one NCCL rank with
               ``force_partition``; the 262,144-row irregular matrix on the
               gathered-x tier (one NCCL rank, ``force_partition``); each
               against the single-device solve on the card (its cycles;
               ‖Δx‖₂ ≤ 2e-10/λ_min), with K6h's and K6's launches, the
               model's bytes against ``Comm.stats``, and the model's HBM
               bytes a cycle over the measured cycle time × copy bandwidth
               for the two one-rank NCCL solves (256³ stencil, 1024² ELL);
               and K6's halo form (K6h) on the inner row blocks of the
               1024² level 0 (H = 1024) and the k-9 512² level (H = 513)
               cut in 4, against its plain version and the whole-vector
               K6's rows, timed beside the whole vector's device ms / 4.

Every solve of 11-15 and 14a-14b prints its cycles, final norm, the float64 residual
of the merged pair on the host, warm and first solve ms, peak memory and
the launches of every kernel, and fails on any other launch count.
The kernel phases also hold the down-leg from an iterate (a W-cycle's
second visit, every FMG level) against the plain versions: K1 and K5
"down: from x, 4 rb stages, restrict", K4 "from x, 4 rb + residual".

Each phase prints one line ``<phase> <json>``.  Then come the line
``{"kernels": [...]}``, the card's name and power limit as ``nvidia-smi``
gives them, and last ``{"ok": true, "device": {...}}``.

Tolerances.  K1 (``fused_stages_const_3d``) against its plain version:
2e-6 · max|ref| for an iterate; for a residual or restricted residual
2e-6 · max|b|, the size of the terms whose difference it is.  Float32, the
same order of summation, but nvcc fuses multiply-adds and the region rows
divide where the plain version divides too — a few ulp.  K2
(``df_update_residual_const_3d``): ``x_hi'``, ``x_lo'``, ``r_hi`` equal bit
for bit; the partial sums' total within 1e-6 relative of ``sum(r_hi²)``.
The batched forms K1b–K7b take their scalar kernel's tolerance
against their batched plain versions, and are held bit for bit, member by
member, against the scalar kernel's launch on that member (K2b's partial
row and the norm ``kernels.df_norms`` makes of it too).
K6h against ``spmv_banded_halo_plain`` and the whole-vector K6's rows: bit
for bit by design (the same slot order and round-to-nearest arithmetic),
failing only beyond K6's tolerance.
K3 and K4 (one pass of ``csrc/half_sweep.cu``) against ``half_sweep_plain``
/ ``half_sweep_vary_plain``, K4's legs (``csrc/vary_leg.cu``) against
``sweeps_vary_plain`` (the loop of those passes), and K5
(``fused_stages_2d``) against ``fused_stages_2d_plain``: 2e-6 · max|ref| for
an iterate, 2e-6 · max|b| for a residual, for the same reason as K1.  K6 and K7 against
``spmv_banded_plain``: bit for bit (both sum in the same order with
round-to-nearest products and sums), failing only beyond 2e-6 ·
max_i Σ |terms| (the size of the terms of a row's sum).  Two converged solves of one
system (card and CPU) are held to ‖Δx‖₂ ≤ 2e-10/λ_min: both are within the
threshold of one exact solution.

``bound_ms`` is the least time the card could take: the larger of the bytes
that must move (each input read once, each output written once) over
3.35 TB/s and the float32 operations needed over 67 TFLOP/s (float64: 34
TFLOP/s; the H100 SXM data sheet's rates).  K6 and K7 are charged their
stored (padded) matrix, ``x`` and ``y`` once, and two operations a stored
entry.  K6 and K7's ``ms``, ``plain_ms`` and ``library_ms`` are device time
per call, the calls back to back with the card kept ahead of the host and
each call on another copy of the operands (``device_ms``): the small SpMVs
of the sparse solves take less time on the card than their wrappers take on
the host, which ``time_ms`` would count (``ms_host_paced``), and a level of
up to 50 MB called again on the same operands is read from L2, not from the
device memory its bound counts (``ms_l2_warm``).
``bound_ms_copy_bw`` divides the same bytes by the copy bandwidth measured
in this run instead.  A red/black pass of K3/K4 is
charged what one colour needs (see ``sweep_bound``); ``bound_ms_sectors``
beside it counts whole 32-byte sectors, which is every array in full.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
K1_TOL = 2e-6
SWEEP_TOL = 2e-6
OMEGA = 2.0 / 3.0
# float32 outer residual: the threshold a float32 residual can reach with
# ‖b‖₂ = 1 (its rounding floor is about eps·‖A‖·‖x‖, a few 1e-6 here)
F32_THRESHOLD = 1e-5
# ... and for the 1024² 2D Poisson solve, whose float32 residual stalls at
# about 1.15e-5 (the plain version on the CPU, seed 5)
F32_THRESHOLD_2D = 2e-5
BIG = (256, 256, 256)  # the full-width grid of every phase
DIFFUSION_CFG = dict(
    smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
    max_dense_coarse=4096,
)


def medium(shape):
    """The smooth random medium of the diffusion runs, κ in [0.5, 1.5)."""
    return 0.5 + np.random.default_rng(12).random(shape)


_CLOCK = [time.perf_counter()]


def emit(phase, obj):
    """Print a phase's line, with ``wall_s``: the seconds since the last
    line (the phase and the set-up before it), for the script's budget."""
    now = time.perf_counter()
    obj = {**obj, "wall_s": now - _CLOCK[0]} if isinstance(obj, dict) else obj
    _CLOCK[0] = now
    print(f"{phase} {json.dumps(obj)}", flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def run_text(cmd):
    return subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60, check=True,
    ).stdout.strip()


def device_ms(fns, reps=20):
    """Device milliseconds per call, the calls back to back and rotating
    over ``fns``.  The card is held busy (``torch.cuda._sleep``, twice the
    time the host took to enqueue the calls) while the timed calls are
    enqueued, so the events do not count the host's cost of a call, which
    ``time_ms`` does for a call shorter than its enqueue.  Where each of
    ``fns`` works on its own copy of the operands (``operand_copies``),
    every call finds its operands evicted from L2 by the copies read since
    its last use, and reads them from device memory, as its bound by bytes
    assumes; one function called again finds in L2 what fits there."""
    fns = list(fns)
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_s, 5.0) * 2e9))  # at most ~2 GHz
    a.record()
    for i in range(reps):
        fns[i % len(fns)]()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# bytes read between two uses of one operand copy: four times the H100's
# 50 MB L2
ROTATE_BYTES = 200e6


def operand_copies(nbytes, reps=20):
    """How many copies of a call's operands (``nbytes`` in all) keep
    ``ROTATE_BYTES`` between two uses of one copy, at most ``reps``: a case
    of under 10 MB stays in L2 even so (it is launch-bound)."""
    return max(1, min(reps, math.ceil(ROTATE_BYTES / nbytes)))


def time_ms(fn, reps, warm=2):
    """Median milliseconds of ``fn()`` by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def randn(shape, seed, dev, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a * np.float32(scale)).to(dev)


def randn_card(shape, seed, dev, scale=1.0, dtype=torch.float32):
    """Normal random numbers made on the card from ``seed`` (the batched
    phases' operands: eight members a case, too many to draw on the host
    within the script's time)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=dtype) * scale


def check_outputs(what, outs, got, ref, b):
    """Hold each output of a fused call against the plain version's:
    K1_TOL · max|ref| for an iterate ``x``, K1_TOL · max|b| for a residual
    or restricted residual ``r``.  Returns (largest error, errors by
    output)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    worst, errs = 0.0, {}
    for name, g, r in zip(outs, got, ref):
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            fail(f"{what}: bad output {name}")
        err = float((g - r).abs().max())
        scale = float((b if name == "r" else r).abs().max())
        errs[name] = {"max_abs_err": err, "max_ref": float(r.abs().max()),
                      "tolerance": K1_TOL * scale}
        worst = max(worst, err)
        if err > K1_TOL * scale:
            fail(f"{what} {name}: err {err:.3e} > {K1_TOL * scale:.3e}")
    return worst, errs


def timings(run, run_plain, nbytes, flops, copy_bw, reps, plain_reps=3):
    """The kernel's and the plain version's median ms, and the bound: the
    larger of the bytes over the memory rate and the operations over the
    float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return dict(
        ms=time_ms(run, reps), plain_ms=time_ms(run_plain, plain_reps, warm=1),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_ms_copy_bw=nbytes / copy_bw * 1e3, bytes=nbytes, flops=flops,
    )


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(dev):
    smi = run_text(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    )
    try:
        from openmg_tpu_torch._build import _nvcc

        nvcc = run_text([_nvcc(), "--version"]).splitlines()[-2:]
    except RuntimeError as e:
        fail(str(e))
    n = 1 << 28  # 1 GiB of float32
    src = torch.empty(n, dtype=torch.float32, device=dev).normal_()
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    copy_bw = 2 * n * 4 / (ms * 1e-3)
    del src, dst
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("env", {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "triton": triton_version,
        "nvcc": nvcc,
        "nvidia_smi": smi,
        "capability": list(torch.cuda.get_device_capability(0)),
        "copy_bandwidth_GBps": copy_bw / 1e9,
        "copy_ms_1GiB": ms,
    })
    return smi, copy_bw


def phase_build():
    from openmg_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    wall = time.perf_counter() - t0
    used = [
        ln.strip() for ln in _build.info.get("log", "").splitlines()
        if "registers" in ln or "spill" in ln
    ]
    emit("build", {
        "seconds": wall, "cached": _build.info.get("cached"),
        "library": _build.info.get("path", "").split("/")[-1],
        "flags": " ".join(_build.NVCC_FLAGS), "ptxas": used,
    })
    return wall


def k1_modes(fused, op, tr, b, x, ec):
    """name -> (callable on (b, x, ec), kinds of the outputs)."""
    V, O = op.values, op.offsets
    corner = fused._corner_info(op)
    rb4 = fused.stages_for("rbgs", 2, OMEGA)
    jac6 = fused.stages_for("jacobi", 6, OMEGA)

    def make(**kw):
        return lambda impl, bb, xx: impl(V, O, bb, xx, corner=corner, **kw)

    return {
        "down: zero start, 4 rb stages, restrict": (
            make(stages=rb4, emit_residual=True, restrict_transfer=tr),
            False, ("x", "r")),
        # the down-leg of a W-cycle's second visit and of every FMG level
        "down: from x, 4 rb stages, restrict": (
            make(stages=rb4, emit_residual=True, restrict_transfer=tr),
            True, ("x", "r")),
        "up: x + P ec, 4 rb stages": (
            make(stages=rb4, ec=ec, prolong_transfer=tr), True, ("x",)),
        "x + P ec, no stages": (
            make(stages=(), ec=ec, prolong_transfer=tr), True, ("x",)),
        "6 jacobi stages": (make(stages=jac6), True, ("x",)),
        "residual + restrict, no x out": (
            make(stages=(), emit_residual=True, restrict_transfer=tr,
                 emit_x=False), True, ("r",)),
        "zero start, 4 rb stages, residual": (
            make(stages=rb4, emit_residual=True), False, ("x", "r")),
    }


def k1_bound(mode, n, nc, K):
    """(bytes, flops) the mode needs at n fine and nc coarse points."""
    stage_rb = n / 2 * 2 * K          # one colour: K−1 mul-adds, sub, mul
    stage_j = n * (2 * K + 3)
    resid = n * 2 * K
    restr = nc * 2 * 27
    if mode.startswith("down: from x"):
        return 4 * (3 * n + nc), 4 * stage_rb + resid + restr
    if mode.startswith("down"):
        return 4 * (n + n + nc), 4 * stage_rb + resid + restr
    if mode.startswith("up"):
        return 4 * (n + n + nc + n), 4 * stage_rb + n * 8
    if mode.startswith("x + P ec"):
        return 4 * (n + nc + n), n * 8
    if mode.startswith("6 jacobi"):
        return 4 * 3 * n, 6 * stage_j
    if mode.startswith("residual + restrict"):
        return 4 * (2 * n + nc), resid + restr
    return 4 * 3 * n, 4 * stage_rb + resid


def k2_bound(n, terms, emit_norm):
    """(bytes, flops) of K2 at n points: five arrays read, three written."""
    nterms = sum(len(t) for t in terms)
    return 32 * n, n * (8 + 13 * nterms + (2 if emit_norm else 0))


def phase_kernels(dev, copy_bw):
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import doublefloat as df
    from openmg_tpu_torch.ops import fused, kernels
    from openmg_tpu_torch.ops.stencil import StencilOperator

    reps = 12
    plain_reps = 3
    cfg = mg.SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
        max_dense_coarse=4096,
    )
    big = BIG
    h_big = mg.setup(big, cfg, device=dev).hierarchy
    h_odd = mg.setup(
        (20, 36, 72), mg.SolverConfig(
            smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
            gridlevels=3, max_dense_coarse=1024),
        device=dev,
    ).hierarchy
    tr = h_big.transfer
    # every visited level of the 256³ hierarchy: the constant 256³ level and
    # the cornered 27-point 128³, 64³ and 32³ levels
    levels = [("main", L) for L in h_big.levels[:-1]]
    levels += [("odd", L) for L in h_odd.levels[:-1]]
    # a stencil whose tap count is neither 7 nor 27 takes the kernel's
    # generic instantiation: a 19-point operator (faces and edges)
    offs19 = tuple(
        (dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
        for dx in (-1, 0, 1) if abs(dz) + abs(dy) + abs(dx) <= 2
    )
    vals19 = [
        {0: 24.0, 1: -2.0, 2: -1.0}[abs(o[0]) + abs(o[1]) + abs(o[2])]
        for o in offs19
    ]
    op19 = StencilOperator(
        None, offs19, torch.tensor(vals19, dtype=torch.float32, device=dev),
        (20, 36, 72),
    )
    levels.append(("generic", types.SimpleNamespace(A=op19, grid_shape=op19.grid_shape)))

    rows = []
    for tag, L in levels:
        op = L.A
        shape = L.grid_shape
        n = int(np.prod(shape))
        cshape = tuple(s // 2 for s in shape)
        nc = int(np.prod(cshape))
        kind = "const" if op.is_constant else "cornered"
        b = randn(shape, 1, dev)
        x = randn(shape, 2, dev)
        ec = randn(cshape, 3, dev)
        for mode, (call, has_x, outs) in k1_modes(fused, op, tr, b, x, ec).items():
            xin = x if has_x else None
            got = call(fused.fused_stages_const_3d, b, xin)
            torch.cuda.synchronize()
            ref = call(fused.fused_stages_const_3d_plain, b, xin)
            torch.cuda.synchronize()
            worst, errs = check_outputs(f"K1 {mode} {kind} {shape}", outs, got, ref, b)
            del got, ref
            row = {"level": tag, "kind": kind, "shape": list(shape),
                   "taps": len(op.offsets), "mode": mode, "errors": errs,
                   "max_abs_err": worst}
            if tag == "main":
                row.update(timings(
                    lambda: call(fused.fused_stages_const_3d, b, xin),
                    lambda: call(fused.fused_stages_const_3d_plain, b, xin),
                    *k1_bound(mode, n, nc, len(op.offsets)), copy_bw, reps,
                    plain_reps))
            rows.append(row)
        del b, x, ec
        torch.cuda.empty_cache()

    # a visit deeper than one launch takes: 14 Jacobi stages at 256³ are
    # ⌈14 / MAX_DEPTH⌉ launches of the same kernel
    L0 = h_big.levels[0]
    b = randn(big, 1, dev)
    x = randn(big, 2, dev)
    jac14 = fused.stages_for("jacobi", 14, OMEGA)
    before = fused.LAUNCHES
    got = fused.fused_stages_const_3d(L0.A.values, L0.A.offsets, b, x, jac14)
    torch.cuda.synchronize()
    deep_launches = fused.LAUNCHES - before
    want = -(-len(jac14) // fused.MAX_DEPTH)
    if deep_launches != want:
        fail(f"K1: 14 Jacobi stages took {deep_launches} launches, not {want}")
    ref = fused.fused_stages_const_3d_plain(L0.A.values, L0.A.offsets, b, x, jac14)
    worst, errs = check_outputs("K1 14 jacobi stages", ("x",), got, ref, b)
    del got, ref
    n = int(np.prod(big))
    deep = {"level": "main", "kind": "const", "shape": list(big),
            "taps": len(L0.A.offsets), "mode": "14 jacobi stages (split)",
            "launches": deep_launches, "errors": errs, "max_abs_err": worst}
    deep.update(timings(
        lambda: fused.fused_stages_const_3d(L0.A.values, L0.A.offsets, b, x, jac14),
        lambda: fused.fused_stages_const_3d_plain(L0.A.values, L0.A.offsets, b, x, jac14),
        4 * 3 * n, 14 * n * (2 * len(L0.A.offsets) + 3), copy_bw, reps, 1))
    rows.append(deep)
    del b, x
    torch.cuda.empty_cache()

    # coarse solve, for the breakdown of a cycle (a library product, as in
    # the JAX package; not a kernel of the port)
    from openmg_tpu_torch.core.cycle import coarse_solve

    bc = randn(h_big.levels[-1].grid_shape, 4, dev)
    coarse_ms = time_ms(lambda: coarse_solve(h_big, bc), reps)

    # K2
    offs = h_big.fine_hi.offsets
    terms = tuple(df.pow2_terms(float(v)) for v in h_big.fine_hi.values.cpu().numpy())
    k2_rows = []
    for tag, shape in (("main", big), ("odd", (20, 36, 72))):
        rng = np.random.default_rng(5)
        xh, xl = df.df_split(rng.standard_normal(shape), dev)
        bh, bl = df.df_split(rng.standard_normal(shape), dev)
        e = randn(shape, 6, dev, scale=1e-3)
        n = int(np.prod(shape))
        for emit_norm in (True, False):
            got = kernels.df_update_residual_const_3d(
                offs, terms, xh, xl, e, bh, bl, emit_norm=emit_norm)
            torch.cuda.synchronize()
            ref = kernels.df_update_residual_const_3d_plain(
                offs, terms, xh, xl, e, bh, bl, emit_norm=emit_norm)
            torch.cuda.synchronize()
            worst = 0.0
            for name, g, r in zip(("x_hi", "x_lo", "r_hi"), got, ref):
                err = float((g - r).abs().max())
                worst = max(worst, err)
                if not torch.equal(g, r):
                    fail(f"K2 {shape} emit_norm={emit_norm}: {name} differs "
                         f"from the plain version (max {err:.3e})")
            row = {"level": tag, "shape": list(shape), "emit_norm": emit_norm,
                   "max_abs_err": worst, "bit_equal": True}
            if emit_norm:
                have = float(torch.sum(got[3]))
                want = float(torch.sum(ref[2] * ref[2]))
                rel = abs(have - want) / want
                if rel > 1e-6:
                    fail(f"K2 {shape}: partial sums {have!r} vs {want!r}")
                # two runs give the same bits: no float atomics
                again = kernels.df_update_residual_const_3d(
                    offs, terms, xh, xl, e, bh, bl, emit_norm=True)
                if not torch.equal(again[3], got[3]):
                    fail("K2: partial sums differ between two runs")
                row.update(norm_rel_err=rel, partials=int(got[3].numel()))
            del got, ref
            if tag == "main":
                row.update(timings(
                    lambda: kernels.df_update_residual_const_3d(
                        offs, terms, xh, xl, e, bh, bl, emit_norm=emit_norm),
                    lambda: kernels.df_update_residual_const_3d_plain(
                        offs, terms, xh, xl, e, bh, bl, emit_norm=emit_norm),
                    *k2_bound(n, terms, emit_norm), copy_bw, reps, plain_reps))
            k2_rows.append(row)
        del xh, xl, bh, bl, e
        torch.cuda.empty_cache()

    emit("kernels", {
        "K1": rows, "K2": k2_rows, "coarse_solve_ms": coarse_ms,
        "k1_max_depth": fused.MAX_DEPTH,
        "k1_tolerance": "2e-6*max|ref| (x), 2e-6*max|b| (r, bc)",
        "k2_tolerance": "bit-equal x_hi, x_lo, r_hi; partial sum 1e-6 relative",
        "timed_launches": reps,
    })
    return rows, k2_rows, coarse_ms


# ---------------------------------------------------------------------------
# the batched forms K1b, K2b, K5b (solve_many's kernels)
# ---------------------------------------------------------------------------

BATCH_K = 8  # members of a batch, as in solve_many


def tup(t):
    return t if isinstance(t, tuple) else (t,)


def batch_case(what, outs, run_b, run_m, run_plain, b, K, bound, copy_bw,
               reps=10, bound_batch=None):
    """One batched launch (``run_b()``) held against its batched plain
    version with the scalar kernel's tolerance, and member by member
    against the scalar kernel's launch on that member (``run_m(m)``) bit
    for bit.  Device ms of the batched launch beside K scalar launches
    (rotating over the members) and the batched bound: K × the scalar
    call's (bytes, flops) ``bound``, or ``bound_batch`` where the operator's
    data is read once for the batch."""
    got = tup(run_b())
    torch.cuda.synchronize()
    ref = tup(run_plain())
    torch.cuda.synchronize()
    worst, errs = check_outputs(what, outs, got, ref, b)
    del ref
    for m in range(K):
        one = tup(run_m(m))
        for name, g, r in zip(outs, got, one):
            if not torch.equal(g[m], r):
                err = float((g[m] - r).abs().max())
                fail(f"{what}: member {m} output {name} is not bit-equal to "
                     f"the scalar launch (max {err:.3e})")
        del one
    del got
    nbytes, flops = bound_batch or (K * v for v in bound)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    ms = device_ms([run_b], reps)
    scalar_ms = device_ms([functools.partial(run_m, m) for m in range(K)], 2 * K)
    return {
        "case": what, "K": K, "errors": errs, "max_abs_err": worst,
        "bit_equal_to_scalar_per_member": True,
        "ms": ms, "ms_per_member": ms / K, "scalar_ms": scalar_ms,
        "K_times_scalar_ms": K * scalar_ms, "batch_over_scalar": ms / (K * scalar_ms),
        "plain_ms": time_ms(run_plain, 1, warm=0),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_ms_copy_bw": nbytes / copy_bw * 1e3, "library_ms": None,
    }


def phase_batch_kernels(dev, copy_bw):
    """K1b, K2b and K5b at full width with K = 8: K1b's down-leg, up-leg
    with ``ec``, residual with restriction and down-leg from x on 256³ and
    on the cornered 128³, 64³ and 32³ levels; K2b on 256³ and on the 4096²
    lift; K5b's down-leg and up-leg on 4096² and on the cornered 2048² and
    256² levels.  Each against its batched plain version (K1's and K5's
    tolerance; K2b bit for bit) and against K launches of the scalar
    kernel, bit for bit member by member; the shape K1b took."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.models.poisson import poisson_offsets
    from openmg_tpu_torch.ops import doublefloat as df
    from openmg_tpu_torch.ops import fused, kernels

    K = BATCH_K
    cfg = mg.SolverConfig(**MAIN_CFG)
    h = mg.setup(BIG, cfg, device=dev).hierarchy
    tr = h.transfer
    picked = ("down: zero start, 4 rb stages, restrict", "up: x + P ec, 4 rb stages",
              "residual + restrict, no x out", "down: from x, 4 rb stages, restrict")
    k1b = []
    for L in h.levels[:-1]:
        op, shape = L.A, L.grid_shape
        kind = "const" if op.is_constant else "cornered"
        cshape = tuple(s // 2 for s in shape)
        n, nc = int(np.prod(shape)), int(np.prod(cshape))
        bB = randn_card((K,) + shape, 21, dev)
        xB = randn_card((K,) + shape, 22, dev)
        ecB = randn_card((K,) + cshape, 23, dev)
        modes_b = k1_modes(fused, op, tr, bB, xB, ecB)
        modes_m = [k1_modes(fused, op, tr, bB[m], xB[m], ecB[m]) for m in range(K)]
        for mode in picked:
            call, has_x, outs = modes_b[mode]
            xin = xB if has_x else None
            run_b = functools.partial(call, fused.fused_stages_const_3d_batch, bB, xin)
            run_b()
            torch.cuda.synchronize()
            took = fused.last_shape()

            def run_m(m, mode=mode, has_x=has_x):
                return modes_m[m][mode][0](fused.fused_stages_const_3d, bB[m],
                                           xB[m] if has_x else None)

            row = batch_case(
                f"K1b {mode} {kind} {shape}", outs, run_b, run_m,
                functools.partial(call, fused.fused_stages_const_3d_batch_plain,
                                  bB, xin),
                bB, K, k1_bound(mode, n, nc, len(op.offsets)), copy_bw)
            run_m(0)
            torch.cuda.synchronize()
            row.update(level=f"{shape[0]}^3", kind=kind, shape=[K] + list(shape),
                       mode=mode, shape_batch=took, shape_scalar=fused.last_shape())
            k1b.append(row)
        del bB, xB, ecB, modes_b, modes_m
        torch.cuda.empty_cache()

    # the coarsest level's solve: one gemv a member (what solve_many runs)
    # against one product over the batch, which it would run only if every
    # column kept the gemv's bits
    from openmg_tpu_torch.ops.sparse import matvec_full

    inv = h.coarse_inv
    bc = randn_card((inv.shape[0], K), 27, dev)
    cols = torch.stack([matvec_full(inv, bc[:, m].contiguous()) for m in range(K)], 1)
    prod = matvec_full(inv, bc)
    coarse = {
        "n": int(inv.shape[0]), "K": K,
        "columns_bit_equal_to_gemv": bool(torch.equal(cols, prod)),
        "max_abs_diff": float((cols - prod).abs().max()),
        "gemv_ms_K": K * device_ms([lambda: matvec_full(inv, bc[:, 0].contiguous())], 20),
        "product_ms": device_ms([lambda: matvec_full(inv, bc)], 20),
    }
    del bc, cols, prod
    offs = h.fine_hi.offsets
    terms = tuple(df.pow2_terms(float(v)) for v in h.fine_hi.values.cpu().numpy())
    k2b = []
    for tag, shape, o in (("256^3", BIG, offs),
                          ("4096^2", BIG2, poisson_offsets(2))):
        tm = tuple(df.pow2_terms(float(v)) for v in ([4.0] + [-1.0] * 4)) \
            if len(shape) == 2 else terms
        # (hi, lo) pairs of float64 normals, split on the card as df_split
        # splits on the host
        pairs = []
        for seed in (24, 25):
            a = randn_card((K,) + shape, seed, dev, dtype=torch.float64)
            hi = a.float()
            pairs.append((hi, (a - hi.double()).float()))
            del a
        (xh, xl), (bh, bl) = pairs
        e = randn_card((K,) + shape, 26, dev, scale=1e-3)
        n = int(np.prod(shape))
        got = kernels.df_update_residual_batch(o, tm, xh, xl, e, bh, bl, emit_norm=True)
        torch.cuda.synchronize()
        ref = kernels.df_update_residual_batch_plain(o, tm, xh, xl, e, bh, bl,
                                                     emit_norm=True)
        for name, g, r in zip(("x_hi", "x_lo", "r_hi"), got, ref):
            if not torch.equal(g, r):
                fail(f"K2b {tag}: {name} differs from the plain version")
        norms = kernels.df_norms(got[3])
        for m in range(K):
            one = kernels.df_update_residual_const_3d(
                o, tm, xh[m], xl[m], e[m], bh[m], bl[m], emit_norm=True)
            for name, g, r in zip(("x_hi", "x_lo", "r_hi", "partials"), got, one):
                if not torch.equal(g[m], r):
                    fail(f"K2b {tag}: member {m} {name} is not bit-equal to "
                         "the scalar launch")
            if not torch.equal(norms[m], torch.sqrt(torch.sum(one[3]))):
                fail(f"K2b {tag}: member {m}'s norm is not the scalar step's")
            want = float(torch.sum(ref[2][m] * ref[2][m]))
            if abs(float(norms[m]) ** 2 - want) > 1e-6 * want:
                fail(f"K2b {tag}: member {m}'s partials sum to "
                     f"{float(norms[m]) ** 2!r}, not {want!r}")
            del one
        del got, ref

        def run_b(o=o, tm=tm, xh=xh, xl=xl, e=e, bh=bh, bl=bl):
            return kernels.df_update_residual_batch(o, tm, xh, xl, e, bh, bl,
                                                    emit_norm=True)

        def run_m(m, o=o, tm=tm, xh=xh, xl=xl, e=e, bh=bh, bl=bl):
            return kernels.df_update_residual_const_3d(
                o, tm, xh[m], xl[m], e[m], bh[m], bl[m], emit_norm=True)

        nbytes, flops = (K * v for v in k2_bound(n, tm, True))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        ms = device_ms([run_b], 10)
        scalar_ms = device_ms([functools.partial(run_m, m) for m in range(K)], 2 * K)
        k2b.append({
            "case": f"K2b {tag}", "level": tag, "K": K, "shape": [K] + list(shape),
            "mode": "emit_norm", "max_abs_err": 0.0, "bit_equal_to_plain": True,
            "bit_equal_to_scalar_per_member": True,
            "partials": list(kernels.df_update_residual_batch(
                o, tm, xh[:1], xl[:1], e[:1], bh[:1], bl[:1], emit_norm=True)[3].shape),
            "ms": ms, "ms_per_member": ms / K, "scalar_ms": scalar_ms,
            "K_times_scalar_ms": K * scalar_ms, "batch_over_scalar": ms / (K * scalar_ms),
            "plain_ms": time_ms(lambda o=o, tm=tm, xh=xh, xl=xl, e=e, bh=bh, bl=bl:
                                kernels.df_update_residual_batch_plain(
                                    o, tm, xh, xl, e, bh, bl, emit_norm=True), 1, warm=0),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_copy_bw": nbytes / copy_bw * 1e3, "library_ms": None,
        })
        del xh, xl, bh, bl, e
        torch.cuda.empty_cache()
    del h
    torch.cuda.empty_cache()

    h2 = mg.setup(BIG2, cfg, device=dev).hierarchy
    tr = h2.transfer
    k5b = []
    # 4096², the cornered 2048² and the cornered 256² (latency-bound) levels
    for L in (h2.levels[0], h2.levels[1], h2.levels[min(4, h2.num_levels - 2)]):
        op, shape = L.A, L.grid_shape
        kind = "const" if op.is_constant else "cornered"
        cshape = tuple(s // 2 for s in shape)
        n, nc = int(np.prod(shape)), int(np.prod(cshape))
        bB = randn_card((K,) + shape, 31, dev)
        xB = randn_card((K,) + shape, 32, dev)
        ecB = randn_card((K,) + cshape, 33, dev)
        modes_b = k5_modes(op, tr, ecB)
        modes_m = [k5_modes(op, tr, ecB[m]) for m in range(K)]
        for mode in picked[:2]:
            call, has_x, outs = modes_b[mode]
            xin = xB if has_x else None

            def run_m(m, mode=mode, has_x=has_x):
                return modes_m[m][mode][0](kernels.fused_stages_2d, bB[m],
                                           xB[m] if has_x else None)

            row = batch_case(
                f"K5b {mode} {kind} {shape}", outs,
                functools.partial(call, kernels.fused_stages_2d_batch, bB, xin),
                run_m,
                functools.partial(call, kernels.fused_stages_2d_batch_plain, bB, xin),
                bB, K, k5_bound(mode, n, nc, len(op.offsets)), copy_bw)
            row.update(level=f"{shape[0]}^2", kind=kind, shape=[K] + list(shape),
                       mode=mode)
            k5b.append(row)
        del bB, xB, ecB, modes_b, modes_m
        torch.cuda.empty_cache()
    del h2
    torch.cuda.empty_cache()
    emit("batch_kernels", {
        "K": K, "K1b": k1b, "K2b": k2b, "K5b": k5b, "coarse_solve": coarse,
        "tolerance": "K1b/K5b: 2e-6*max|ref| (x), 2e-6*max|b| (r, bc) against "
                     "the batched plain version; every member bit-equal to the "
                     "scalar launch; K2b bit-equal to both",
        "ms": "device ms of one launch (batched) or of one scalar launch, the "
              "scalar launches rotating over the members",
    })
    return k1b, k2b, k5b


def residual_norm_host(b64, x64):
    """‖b − A x‖₂ of the (2d+1)-point Poisson operator in float64 (numpy
    shifts, no matrix)."""
    d = x64.ndim
    ax = 2.0 * d * x64
    for axis in range(d):
        lo = [slice(None)] * d
        hi = [slice(None)] * d
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        ax[tuple(lo)] -= x64[tuple(hi)]
        ax[tuple(hi)] -= x64[tuple(lo)]
    r = b64 - ax
    return float(np.sqrt(np.sum(r * r)))


def phase_solve(dev):
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import fused, kernels

    shape = BIG
    cfg = mg.SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
        max_dense_coarse=4096, cycles=60,
    )
    t0 = time.perf_counter()
    solver = mg.setup(shape, cfg, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    levels = [list(s[0]) for s in solver.hierarchy.stats]

    bnp = mg.rhs_random(shape, seed=1)
    bnp /= np.linalg.norm(bnp.ravel())
    b = torch.from_numpy(bnp.astype(np.float32)).to(dev)

    # the main path, with the launch counts read around it
    zero_counts()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    main_counts = counts()
    k1, k2 = main_counts["K1"], main_counts["K2"]
    cycles = info["cycles"]
    visits = 2 * (solver.hierarchy.num_levels - 1)
    if not info["converged"] or not info["final_norm"] < 1e-10:
        fail(f"solve did not converge: {info['residual_norms']}")
    if cycles > 9:
        fail(f"solve took {cycles} cycles (> 9)")
    if cycles == 0 or main_counts != {"K1": visits * cycles, "K2": cycles,
                                      "K3": 0, "K4": 0, "K5": 0}:
        fail(f"launch counts {main_counts} for {cycles} cycles, "
             f"{visits} level visits each")
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.is_cuda and tuple(x.shape) == shape):
        fail("solve did not deliver a float32 tensor on the card")
    hi, lo = info["x_df"]
    if not bool(torch.isfinite(hi).all() and torch.isfinite(lo).all()):
        fail("solution is not finite")
    x64 = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
    rn64 = residual_norm_host(b.cpu().numpy().astype(np.float64), x64)
    if not rn64 < 2e-10:
        fail(f"float64 residual of the merged pair is {rn64:.3e}")

    # second solve, warm: the times
    torch.cuda.reset_peak_memory_stats()
    x2, info2 = solver.solve(b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(x2, x):
        fail("two solves of the same system differ")

    # the same solve under the profiler: the device's launches of K1 (one a
    # level visit, 8 a cycle) and the breakdown by kernel
    before = fused.LAUNCHES
    prof = profile_solve(solver, b, top=16)
    prof_counted = fused.LAUNCHES - before
    k1_device = sum(v["count"] for k, v in prof["kernels"].items()
                    if "visit_kernel" in k)
    if k1_device != prof_counted or k1_device != visits * cycles:
        fail(f"profiler: {k1_device} K1 launches on the device, "
             f"{prof_counted} counted, {visits * cycles} level visits")
    emit("solve_profile", {"shape": list(shape), "cycles": cycles,
                           "k1_device_launches": k1_device, **prof})

    # a small solve on the card against the same solve on the CPU (plain
    # versions): same cycle count, solutions within the threshold's reach
    small = (32, 32, 64)
    scfg = mg.SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
        gridlevels=3, max_dense_coarse=1024,
    )
    bs = mg.rhs_random(small, seed=0)
    bs /= np.linalg.norm(bs.ravel())
    xg, ig = mg.solve(small, bs, scfg, device=dev)
    xc, ic = mg.solve(small, bs, scfg, device="cpu")
    lam_min = sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in small)
    dx = float(np.linalg.norm((xg - xc).ravel()))
    if not (ig["converged"] and ig["cycles"] == ic["cycles"]
            and dx <= 2e-10 / lam_min):
        fail(f"small solve: card {ig['cycles']} cycles, CPU {ic['cycles']}, "
             f"|dx| = {dx:.3e}")

    # numpy float64 in, numpy float64 out, through mg_solve and its parameters dict
    mshape = (64,) * 3
    bm = mg.rhs_random(mshape, seed=3)
    bm /= np.linalg.norm(bm.ravel())
    xm, im = mg.mg_solve(None, bm.ravel(), {
        "problemshape": mshape, "transfer": "linear", "max_dense_coarse": 4096,
    })
    rm = float(np.linalg.norm(bm.ravel() - mg.poisson(mshape) @ xm))
    if not (im["converged"] and xm.dtype == np.float64 and rm < 1e-10 * 1.05):
        fail(f"mg_solve: converged={im['converged']} residual {rm:.3e}")

    # V(2,0): the up-leg is the kernel's stage-free prolongation and add;
    # on the card against the same cycle on the CPU (plain versions)
    from openmg_tpu_torch.core.cycle import v_cycle

    hg = mg.setup(small, scfg, device=dev).hierarchy
    hc = mg.setup(small, scfg, device="cpu").hierarchy
    rs = randn(small, 7, dev)
    before = fused.LAUNCHES
    yg = v_cycle(hg, rs, None, pre=2, post=0, x_zero=True)
    torch.cuda.synchronize()
    v20_launches = fused.LAUNCHES - before
    yc = v_cycle(hc, rs.cpu(), None, pre=2, post=0, x_zero=True)
    v20_err = float((yg.cpu() - yc).abs().max())
    v20_tol = 5e-6 * float(yc.abs().max())
    if v20_launches != 2 * (hg.num_levels - 1) or not v20_err <= v20_tol:
        fail(f"V(2,0): {v20_launches} K1 launches, err {v20_err:.3e} "
             f"(tolerance {v20_tol:.3e})")

    # what the kernel does not take is refused on the card, never run as
    # plain tensor code: a float64 right-hand side by the cycle
    refused = []
    for what, call in (
        ("float64 cycle", lambda: v_cycle(hg, rs.double(), None, x_zero=True)),
    ):
        try:
            call()
        except NotImplementedError:
            refused.append(what)
        else:
            fail(f"{what}: ran on the card without the kernel")

    emit("solve", {
        "shape": list(shape), "levels": levels,
        "cycles": cycles, "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn64,
        "launches": {"fused_stages_const_3d": k1,
                     "df_update_residual_const_3d": k2},
        "setup_s": t_setup,
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms": info2["solve_time_s"] * 1e3,
        "ms_per_cycle": info2["solve_time_s"] * 1e3 / max(info2["cycles"], 1),
        "peak_memory_MB": peak / 2 ** 20,
        "small_solve": {"shape": list(small), "cycles_card": ig["cycles"],
                        "cycles_cpu": ic["cycles"], "dx_norm": dx,
                        "dx_bound": 2e-10 / lam_min},
        "mg_solve": {"shape": list(mshape), "cycles": im["cycles"],
                     "residual_float64": rm},
        "v20": {"launches": v20_launches, "max_abs_err": v20_err,
                "tolerance": v20_tol},
        "refused_on_card": refused,
    })
    return k1, k2, cycles, rn64


BIG512 = (512, 512, 512)  # BASELINE config 4 and the North star's size


def phase_solve_512(dev):
    """The main path at 512³: the Poisson solve of ``solve`` on a six-level
    hierarchy (512³ 7-point; 256³, 128³, 64³, 32³ cornered 27-point; 16³
    dense), so K1 takes a cornered 27-point level of 256² planes (its
    marching shape).  One K1 launch a leg, one K2 launch a cycle, no K3."""
    import openmg_tpu_torch as mg

    cfg = mg.SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="doublefloat",
        max_dense_coarse=4096, cycles=60,
    )
    t0 = time.perf_counter()
    solver = mg.setup(BIG512, cfg, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    h = solver.hierarchy
    bnp = mg.rhs_random(BIG512, seed=1)
    bnp /= np.linalg.norm(bnp.ravel())
    b = torch.from_numpy(bnp.astype(np.float32)).to(dev)
    del bnp

    zero_counts()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    main_counts = counts()
    cycles = info["cycles"]
    visits = 2 * (h.num_levels - 1)
    if not info["converged"] or not info["final_norm"] < 1e-10 or cycles > 9:
        fail(f"512^3 solve: {cycles} cycles, {info['residual_norms']}")
    if cycles == 0 or main_counts != {"K1": visits * cycles, "K2": cycles,
                                      "K3": 0, "K4": 0, "K5": 0}:
        fail(f"512^3 solve: launches {main_counts} for {cycles} cycles, "
             f"{visits} level visits each")
    hi, lo = info["x_df"]
    if not bool(torch.isfinite(hi).all() and torch.isfinite(lo).all()):
        fail("512^3 solution is not finite")
    x64 = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
    del hi, lo, x
    rn64 = residual_norm_host(b.cpu().numpy().astype(np.float64), x64)
    del x64
    if not rn64 < 2e-10:
        fail(f"512^3 solve: float64 residual of the merged pair is {rn64:.3e}")

    # second solve, warm: the time and the peak memory
    torch.cuda.reset_peak_memory_stats()
    _, info2 = solver.solve(b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("solve_512", {
        "shape": list(BIG512), "levels": [list(st[0]) for st in h.stats],
        "cycles": cycles, "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn64,
        "launches": {"fused_stages_const_3d": main_counts["K1"],
                     "df_update_residual_const_3d": main_counts["K2"],
                     "half_sweep": main_counts["K3"]},
        "setup_s": t_setup,
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms": info2["solve_time_s"] * 1e3,
        "peak_memory_MB": peak / 2 ** 20,
    })
    del solver, h, b, info, info2
    torch.cuda.empty_cache()


SWEEP_MODES = (
    ("jacobi", "jacobi", 0), ("rb colour 0", "rbgs", 0),
    ("rb colour 1", "rbgs", 1), ("residual", "residual", 0),
)


def sweep_bound(n, offsets, vary, mode):
    """(bytes, flops, sector bytes) that one pass over n points needs.

    Jacobi and residual: b and x read, out written, and for per-point
    coefficients the K grids read.  One red/black colour computes at half
    the points: out is written everywhere, but b and the K grids are needed
    at the colour's points only, and x at the other colour's points (copied
    through, and the neighbours) plus, where a tap couples points of one
    colour (27-point levels), at the colour's own points too.  The third
    number is what moves when every 32-byte sector that holds a needed
    value is read whole: with the colours interleaved along x that is every
    array in full, the Jacobi figure."""
    K = len(offsets)
    full = 4 * n * (3 + (K if vary else 0))
    if mode != "rbgs":
        return full, n * (2 * K + 3), full
    same_colour = any(sum(off) % 2 == 0 and any(off) for off in offsets)
    x_bytes = 4 * n if same_colour else 2 * n
    nbytes = 4 * n + x_bytes + 2 * n + (2 * n * K if vary else 0)
    return nbytes, (n // 2) * (2 * K + 1), full


def conv_ms(op, x, reps):
    """Milliseconds of ``A x`` as one library call (cuDNN in full float32,
    ``F.conv3d`` or ``F.conv2d`` by the grid's rank) for a constant
    operator: the yardstick beside K3's and K5's residual; the port never
    calls it."""
    conv = F.conv3d if x.ndim == 3 else F.conv2d
    w = torch.zeros((1, 1) + (3,) * x.ndim, dtype=torch.float32, device=x.device)
    for k, off in enumerate(op.offsets):
        w[(0, 0) + tuple(o + 1 for o in off)] = op.values[k]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xn = x[None, None]
        got = conv(xn, w, padding=1)[0, 0]
        ms = time_ms(lambda: conv(xn, w, padding=1), reps)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return ms, got


LEG_MODES = (
    # (name, start from x?, passes, mode, residual)
    ("down: zero start, 4 rb + residual", False, 4, "rbgs", True),
    ("up: 4 rb from x", True, 4, "rbgs", False),
    # the down-leg of a W-cycle's second visit and of every FMG level
    ("from x, 4 rb + residual", True, 4, "rbgs", True),
    ("jacobi down: zero start, 2 + residual", False, 2, "jacobi", True),
    ("jacobi up: 2 from x", True, 2, "jacobi", False),
)


def leg_bound(n, K, from_x, passes, mode, residual):
    """(bytes, flops) a leg needs: the K coefficient grids and b (and x)
    read once, x (and r) written once; the operations of its passes (a
    red/black pass computes at half the points) and of the residual.  The
    grid of 1/diag that the main path passes is not counted: the
    coefficients give it."""
    nbytes = 4 * n * (K + 1 + int(from_x) + int(passes > 0) + int(residual))
    per = (n // 2) * (2 * K + 1) if mode == "rbgs" else n * (2 * K + 3)
    return nbytes, passes * per + (n * (2 * K + 3) if residual else 0)


def leg_rows(dev, cases, copy_bw, reps=12, plain_reps=3):
    """K4's legs (``sweeps_vary_3d``) against the plain loop of passes on
    the same card tensors, in every mode of ``LEG_MODES``; timed cases also
    time the same passes one launch each (``csrc/half_sweep.cu``, how the
    cycle ran them before) and the bound."""
    from openmg_tpu_torch.ops import kernels

    rows = []
    for tag, op, inv, timed in cases:
        shape = op.grid_shape
        n = int(np.prod(shape))
        K = len(op.offsets)
        b = randn(shape, 31, dev)
        x0 = randn(shape, 32, dev)
        for mode_name, from_x, passes, mode, res in LEG_MODES:
            x = x0 if from_x else None

            def run(x=x, passes=passes, mode=mode, res=res):
                return kernels.sweeps_vary_3d(
                    op.coeffs, op.offsets, b, x, passes, mode, OMEGA,
                    emit_residual=res, inv_diag=inv)

            def plain(x=x, passes=passes, mode=mode, res=res):
                return kernels.sweeps_vary_plain(
                    op.coeffs, op.offsets, b, x, passes, mode, OMEGA, res,
                    inv_diag=inv)

            before = kernels.LAUNCHES_K4
            got = run()
            torch.cuda.synchronize()
            launches = kernels.LAUNCHES_K4 - before
            want = len(kernels.leg_chunks(passes, res, kernels.leg_depth(K, n)))
            if launches != want:
                fail(f"K4 leg {tag} {mode_name}: {launches} launches, "
                     f"expected {want}")
            got = got if res else (got,)
            ref = plain()
            ref = ref if res else (ref,)
            errs = []
            for what, g, r in zip(("x", "r"), got, ref):
                if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                    fail(f"K4 leg {tag} {mode_name}: bad output {what}")
                err = float((g - r).abs().max())
                tol = SWEEP_TOL * float((b if what == "r" else r).abs().max())
                if err > tol:
                    fail(f"K4 leg {tag} {shape} {mode_name} {what}: err "
                         f"{err:.3e} > {tol:.3e}")
                errs.append({"output": what, "max_abs_err": err,
                             "tolerance": tol})
            del got, ref
            row = {"level": tag, "shape": list(shape), "taps": K,
                   "mode": mode_name, "launches": launches,
                   "max_abs_err": max(e["max_abs_err"] for e in errs),
                   "errors": errs}
            if timed:
                nbytes, flops = leg_bound(n, K, from_x, passes, mode, res)

                def per_pass(x=x, passes=passes, mode=mode, res=res):
                    y = torch.zeros_like(b) if x is None else x
                    for j in range(passes):
                        y = kernels._half_sweep_vary(
                            op.coeffs, b, y, offsets=op.offsets, mode=mode,
                            omega=OMEGA, color=j & 1)
                    if res:
                        kernels._half_sweep_vary(
                            op.coeffs, b, y, offsets=op.offsets,
                            mode="residual", omega=0.0, color=0)

                row.update(timings(run, plain, nbytes, flops, copy_bw, reps,
                                   plain_reps),
                           per_pass_ms=time_ms(per_pass, reps),
                           per_pass_launches=passes + int(res),
                           library_ms=None)
            rows.append(row)
        del b, x0
        torch.cuda.empty_cache()
    return rows


def phase_sweeps(dev, copy_bw, h_vary, h_unfaced):
    """K3 and K4 against their plain versions, pass by pass, and K4's legs
    (one launch of ``csrc/vary_leg.cu`` for the passes of a leg and its
    residual)."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import fused, kernels
    from openmg_tpu_torch.ops.stencil import StencilOperator, apply

    reps, plain_reps = 12, 3
    cfg = mg.SolverConfig(**DIFFUSION_CFG)
    odd = (20, 36, 72)
    odd_cfg = mg.SolverConfig(**{**DIFFUSION_CFG, "gridlevels": 3,
                                 "max_dense_coarse": 1024})
    h_big = mg.setup(BIG, cfg, device=dev).hierarchy
    h_odd = mg.setup(odd, odd_cfg, device=dev).hierarchy
    hv_odd = mg.setup(mg.diffusion_stencil(medium(odd)), odd_cfg,
                      device=dev).hierarchy
    offs2, cf2 = mg.diffusion_stencil(medium((36, 72)))
    op2v = StencilOperator(
        torch.from_numpy(cf2.astype(np.float32)).to(dev), offs2)
    op2c = StencilOperator(
        None, offs2,
        torch.tensor([4.0, -1, -1, -1, -1], dtype=torch.float32, device=dev),
        (36, 72))
    # (tag, operator, timed)
    cases = [
        ("main 256^3", h_big.levels[0].A, True),
        ("main 128^3", h_big.levels[1].A, True),
        ("main 64^3", h_big.levels[2].A, False),
        ("main 32^3", h_big.levels[3].A, False),
        ("odd", h_odd.levels[0].A, False),
        ("odd coarse", h_odd.levels[1].A, False),
        ("2D lift", op2c, False),
        ("main 256^3", h_vary.levels[0].A, True),
        ("main 128^3", h_vary.levels[1].A, True),
        ("main 64^3", h_vary.levels[2].A, False),
        ("main 32^3", h_vary.levels[3].A, False),
        ("odd", hv_odd.levels[0].A, False),
        ("odd coarse", hv_odd.levels[1].A, False),
        ("2D lift", op2v, False),
    ]
    rows = {"K3": [], "K4": []}
    for tag, op, timed in cases:
        shape = op.grid_shape
        n = int(np.prod(shape))
        K = len(op.offsets)
        vary = not (op.is_constant or hasattr(op, "table"))
        kern = "K4" if vary else "K3"
        kind = "varying" if vary else ("const" if op.is_constant else "cornered")
        b = randn(shape, 11, dev)
        x = randn(shape, 12, dev)
        lift = len(shape) == 2
        for mode_name, mode, color in SWEEP_MODES:
            if vary:
                coef, kw = op.coeffs, {}
                half, plain = kernels._half_sweep_vary, kernels.half_sweep_vary_plain
            else:
                coef, kw = op.values, {"corner": fused._corner_info(op)}
                half, plain = kernels._half_sweep, kernels.half_sweep_plain
            if lift:
                # through the public entry points, which lift to (1, ny, nx)
                name = {"jacobi": "jacobi", "residual": "residual",
                        "rbgs": "rbgs_half_sweep"}[mode]
                fn = getattr(kernels, f"{name}_{'vary' if vary else 'const'}_3d")
                args = {"jacobi": (1, OMEGA), "rbgs": (color,), "residual": ()}[mode]
                run = lambda bb, xx: fn(coef, op.offsets, bb, xx, *args)
                c3 = coef[:, None] if vary else coef
                o3 = kernels._lift2d(op.offsets)
                ref = plain(c3, o3, b[None], x[None], mode, OMEGA, color)[0]
            else:
                run = lambda bb, xx: half(
                    coef, bb, xx, offsets=op.offsets, mode=mode, omega=OMEGA,
                    color=color, **kw)
                ref = plain(coef, op.offsets, b, x, mode, OMEGA, color, **kw)
            before = kernels.LAUNCHES_K4 if vary else kernels.LAUNCHES_K3
            got = run(b, x)
            torch.cuda.synchronize()
            after = kernels.LAUNCHES_K4 if vary else kernels.LAUNCHES_K3
            if after - before != 1:
                fail(f"{kern} {tag} {mode_name}: {after - before} launches counted")
            if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
                fail(f"{kern} {tag} {mode_name} {shape}: bad output")
            err = float((got - ref).abs().max())
            scale = float((b if mode == "residual" else ref).abs().max())
            if err > SWEEP_TOL * scale:
                fail(f"{kern} {tag} {kind} {shape} {mode_name}: err {err:.3e} "
                     f"> {SWEEP_TOL * scale:.3e}")
            row = {"level": tag, "kind": kind, "shape": list(shape), "taps": K,
                   "mode": mode_name, "max_abs_err": err,
                   "tolerance": SWEEP_TOL * scale}
            del got
            if timed:
                nbytes, flops, sectors = sweep_bound(n, op.offsets, vary, mode)
                row.update(timings(
                    lambda: run(b, x),
                    lambda: plain(coef, op.offsets, b, x, mode, OMEGA, color, **kw),
                    nbytes, flops, copy_bw, reps, plain_reps),
                    bound_ms_sectors=sectors / PEAK_BYTES_PER_S * 1e3,
                    library_ms=None)
                if kind == "const" and mode == "residual" and K <= 27:
                    # b − conv3d(x): the one library call that computes A x
                    lib_ms, ax = conv_ms(op, x, reps)
                    lib_err = float((ax - apply(op, x)).abs().max())
                    if lib_err > 2e-6 * float(x.abs().max()) * 12:
                        fail(f"conv3d yardstick disagrees: {lib_err:.3e}")
                    row.update(library_ms=lib_ms, library="F.conv3d 3x3x3, "
                               "zero padding, TF32 off (computes A x only)")
                    del ax
            del ref
            rows[kern].append(row)
        del b, x
        torch.cuda.empty_cache()
    # the legs: every varying level of the diffusion hierarchy, the odd
    # shape, the 2D lift and the unfaced 27-point levels of the 256³ Poisson
    # hierarchy, with the levels' own 1/diag grids as the cycle passes them
    lv = h_vary.levels
    lu = h_unfaced.levels
    rows["K4_legs"] = leg_rows(dev, [
        ("main 256^3", lv[0].A, lv[0].inv_diag, True),
        ("main 128^3", lv[1].A, lv[1].inv_diag, True),
        ("main 64^3", lv[2].A, lv[2].inv_diag, False),
        ("main 32^3", lv[3].A, lv[3].inv_diag, False),
        ("odd", hv_odd.levels[0].A, hv_odd.levels[0].inv_diag, False),
        ("odd coarse", hv_odd.levels[1].A, hv_odd.levels[1].inv_diag, False),
        ("2D lift", op2v, None, False),
        ("unfaced 128^3", lu[1].A, lu[1].inv_diag, True),
        ("unfaced 64^3", lu[2].A, lu[2].inv_diag, False),
        ("unfaced 32^3", lu[3].A, lu[3].inv_diag, False),
    ], copy_bw)
    emit("sweeps", {
        **rows,
        "tolerance": "2e-6*max|ref| (iterate), 2e-6*max|b| (residual)",
        "timed_launches": reps,
        "leg_depth": kernels.LEG_DEPTH,
    })
    return rows, h_big


def conv_batch_ms(op, xB, reps=10, padding=1):
    """Device ms of ``A x`` for the K members of ``xB`` as one library call
    (``F.conv3d`` with batch K, cuDNN in full float32) for a constant
    operator, and its result: the yardstick beside K3b's residual (and,
    ``padding=(0, 1, 1)`` over slabs extended by their planes, K3h's and
    K3hb's); the port never calls it."""
    w = torch.zeros((1, 1, 3, 3, 3), dtype=torch.float32, device=xB.device)
    for k, off in enumerate(op.offsets):
        w[(0, 0) + tuple(o + 1 for o in off)] = op.values[k]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xn = xB[:, None]
        got = F.conv3d(xn, w, padding=padding)[:, 0]
        ms = device_ms([lambda: F.conv3d(xn, w, padding=padding)], reps)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return ms, got


def phase_batch_sweeps(dev, copy_bw, h_big, h_vary):
    """The batched K3 and K4 (``batch_kernels`` for K3b and K4b) at K = 8
    on the hierarchies of ``sweeps``: K3b's Jacobi, colour and residual
    passes on the constant 256³ and the cornered 128³ Poisson levels (with
    ``F.conv3d`` of batch K beside the residual as a yardstick), K4b's
    down-leg (4 red/black passes from zero and the residual) and up-leg (4
    from x) on the 256³ (7 taps) and 128³ (27 taps) diffusion levels, and
    one K4b pass (the residual) on 256³.  Each against its batched plain
    version with the scalar kernel's tolerance and member by member
    against the scalar launches bit for bit; device ms beside K scalar
    launches and the batched bound (the coefficient grids once, K × the
    member's fields)."""
    from openmg_tpu_torch.ops import fused, kernels
    from openmg_tpu_torch.ops.stencil import apply

    K = BATCH_K
    rows = {"K3b": [], "K4b": []}
    for L in h_big.levels[:2]:
        op, shape = L.A, L.grid_shape
        n = int(np.prod(shape))
        kind = "const" if op.is_constant else "cornered"
        corner = fused._corner_info(op)
        bB = randn_card((K,) + shape, 41, dev)
        xB = randn_card((K,) + shape, 42, dev)
        for mode_name, mode, color in (SWEEP_MODES[0], SWEEP_MODES[2], SWEEP_MODES[3]):
            w = OMEGA if mode == "jacobi" else 0.0
            args = (op.offsets, bB, xB, mode, w, color, corner)

            def run_m(m, mode=mode, w=w, color=color):
                return kernels._half_sweep(op.values, bB[m], xB[m], offsets=op.offsets,
                                           mode=mode, omega=w, color=color,
                                           corner=corner)

            row = batch_case(
                f"K3b {mode_name} {kind} {shape}",
                ("r",) if mode == "residual" else ("x",),
                functools.partial(kernels.half_sweep_batch, op.values, *args), run_m,
                functools.partial(kernels.half_sweep_batch_plain, op.values, *args),
                bB, K, sweep_bound(n, op.offsets, False, mode)[:2], copy_bw)
            if kind == "const" and mode == "residual":
                lib_ms, ax = conv_batch_ms(op, xB)
                lib_err = float((ax - apply(op, xB)).abs().max())
                if lib_err > 2e-6 * float(xB.abs().max()) * 12:
                    fail(f"conv3d batch yardstick disagrees: {lib_err:.3e}")
                row.update(library_ms=lib_ms, library="F.conv3d 3x3x3 with batch "
                           "K, zero padding, TF32 off (computes A x only)")
                del ax
            row.update(level=f"{shape[0]}^3", kind=kind, shape=[K] + list(shape),
                       mode=mode_name)
            rows["K3b"].append(row)
        del bB, xB
        torch.cuda.empty_cache()
    for L in h_vary.levels[:2]:
        op, inv, shape = L.A, L.inv_diag, L.grid_shape
        n, T = int(np.prod(shape)), len(op.offsets)
        bB = randn_card((K,) + shape, 43, dev)
        xB = randn_card((K,) + shape, 44, dev)
        cases = [(name, fx, p, m, r) for name, fx, p, m, r in LEG_MODES[:2]]
        if shape[0] == BIG[0]:
            cases.append(("residual, one pass", True, 0, "residual", True))
        for mode_name, from_x, passes, mode, res in cases:
            xin = xB if from_x else None
            if mode == "residual":
                run_b = functools.partial(kernels.half_sweep_vary_batch, op.coeffs,
                                          op.offsets, bB, xB, "residual")
                plain = functools.partial(kernels.half_sweep_vary_batch_plain,
                                          op.coeffs, op.offsets, bB, xB, "residual")

                def run_m(m):
                    return kernels._half_sweep_vary(op.coeffs, bB[m], xB[m],
                                                    offsets=op.offsets, mode="residual",
                                                    omega=0.0, color=0)

                nbytes, flops, _ = sweep_bound(n, op.offsets, True, "residual")
                outs, launches = ("r",), 1
                fields = 4 * n * 3
            else:
                leg = (op.coeffs, op.offsets, bB, xin, passes, mode, OMEGA, res, inv)
                run_b = functools.partial(kernels.sweeps_vary_batch, *leg)
                plain = functools.partial(kernels.sweeps_vary_batch_plain, *leg)

                def run_m(m, from_x=from_x, passes=passes, mode=mode, res=res):
                    return kernels.sweeps_vary_3d(
                        op.coeffs, op.offsets, bB[m], xB[m] if from_x else None,
                        passes, mode, OMEGA, res, inv)

                nbytes, flops = leg_bound(n, T, from_x, passes, mode, res)
                outs = ("x", "r") if res else ("x",)
                launches = len(kernels.leg_chunks(passes, res,
                                                  kernels.leg_depth(T, n)))
                fields = nbytes - 4 * n * T
            before = kernels.LAUNCHES_K4_BATCH
            run_b()
            torch.cuda.synchronize()
            if kernels.LAUNCHES_K4_BATCH - before != launches:
                fail(f"K4b {mode_name} {shape}: "
                     f"{kernels.LAUNCHES_K4_BATCH - before} launches, not {launches}")
            row = batch_case(
                f"K4b {mode_name} {shape} {T} taps", outs, run_b, run_m, plain, bB, K,
                (nbytes, flops), copy_bw,
                bound_batch=(4 * n * T + K * fields, K * flops))
            row.update(level=f"{shape[0]}^3", kind="varying", taps=T,
                       shape=[K] + list(shape), mode=mode_name,
                       launches_per_call=launches)
            rows["K4b"].append(row)
        del bB, xB
        torch.cuda.empty_cache()
    emit("batch_kernels_k3k4", {
        "K": K, **rows,
        "tolerance": "2e-6*max|ref| (x), 2e-6*max|b| (r) against the batched "
                     "plain version; every member bit-equal to the scalar launch",
        "bound": "K3b: K x the scalar pass; K4b: the coefficient grids once "
                 "and K x the member's fields",
        "ms": "device ms of one batched call (a leg: its launches) or of one "
              "scalar call, the scalar calls rotating over the members",
    })
    return rows


def setup_vary(dev):
    """The 256³ diffusion solver: stencil pair → host Galerkin chain."""
    import openmg_tpu_torch as mg

    shape = BIG
    t0 = time.perf_counter()
    offsets, coeffs = mg.diffusion_stencil(medium(shape))
    t_stencil = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = mg.setup(
        (offsets, coeffs), mg.SolverConfig(**DIFFUSION_CFG, cycles=60), device=dev
    )
    torch.cuda.synchronize()
    return solver, offsets, coeffs, t_stencil, time.perf_counter() - t0


def residual_norm_host_stencil(offsets, coeffs, b64, x64):
    """‖b − A x‖₂ in float64 from the coefficient grids by numpy shifts
    (no matrix)."""
    r = b64.copy()
    for k, off in enumerate(offsets):
        src = tuple(slice(max(0, o), x64.shape[a] + min(0, o))
                    for a, o in enumerate(off))
        dst = tuple(slice(max(0, -o), x64.shape[a] - max(0, o))
                    for a, o in enumerate(off))
        r[dst] -= coeffs[k][dst] * x64[src]
    return float(np.sqrt(np.sum(r * r)))


def legs_per_visit(cfg, taps, points):
    """K4 launches a visit of a varying level with ``taps`` grids of
    ``points`` points takes:
    the down-leg (the pre-smoothing passes from zero and the residual) and
    the up-leg (the post-smoothing passes), each split into
    ``kernels.leg_chunks`` at the operator's ``kernels.leg_depth``."""
    from openmg_tpu_torch.ops import kernels

    per = 2 if cfg.smoother == "rbgs" else 1
    cap = kernels.leg_depth(taps, points)
    return (len(kernels.leg_chunks(per * cfg.pre_iterations, True, cap))
            + len(kernels.leg_chunks(per * cfg.post_iterations, False, cap)))


def legs_per_cycle(cfg, hierarchy):
    """K4 launches a V-cycle of ``hierarchy`` takes on its varying levels
    (the coarsest, solved by its dense inverse, excluded)."""
    return sum(legs_per_visit(cfg, len(L.A.offsets), int(np.prod(L.grid_shape)))
               for L in hierarchy.levels[:-1] if not L.A.is_constant)


def counts():
    from openmg_tpu_torch.ops import fused, kernels

    return {"K1": fused.LAUNCHES, "K2": kernels.LAUNCHES,
            "K3": kernels.LAUNCHES_K3, "K4": kernels.LAUNCHES_K4,
            "K5": kernels.LAUNCHES_K5}


def batch_counts():
    """Launches of the batched forms (K1b-K7b: K members a launch)."""
    from openmg_tpu_torch.ops import bsr, ell, fused, kernels

    return {"K1b": fused.LAUNCHES_BATCH, "K2b": kernels.LAUNCHES_K2_BATCH,
            "K3b": kernels.LAUNCHES_K3_BATCH, "K4b": kernels.LAUNCHES_K4_BATCH,
            "K5b": kernels.LAUNCHES_K5_BATCH, "K6b": ell.LAUNCHES_K6_BATCH,
            "K7b": bsr.LAUNCHES_K7_BATCH}


def zero_counts():
    from openmg_tpu_torch.ops import bsr, ell, fused, kernels

    fused.LAUNCHES = kernels.LAUNCHES = 0
    kernels.LAUNCHES_K3 = kernels.LAUNCHES_K4 = kernels.LAUNCHES_K5 = 0
    ell.LAUNCHES_K6 = bsr.LAUNCHES_K7 = 0
    fused.LAUNCHES_BATCH = kernels.LAUNCHES_K2_BATCH = kernels.LAUNCHES_K5_BATCH = 0
    kernels.LAUNCHES_K3_BATCH = kernels.LAUNCHES_K4_BATCH = 0
    ell.LAUNCHES_K6_BATCH = bsr.LAUNCHES_K7_BATCH = 0


def phase_solve_vary(dev, vary):
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.core import solver as solver_mod
    from openmg_tpu_torch.core.cycle import run_cycle
    from openmg_tpu_torch.ops import smoothers, stencil

    solver, offsets, coeffs, t_stencil, t_setup = vary
    h = solver.hierarchy
    shape = h.grid_shape
    kinds = ["const" if L.A.is_constant else "varying" for L in h.levels]
    bnp = mg.rhs_random(shape, seed=1)
    bnp /= np.linalg.norm(bnp.ravel())
    b = torch.from_numpy(bnp.astype(np.float32)).to(dev)

    # the main path of this slice, with the launch counts read around it
    zero_counts()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    main_counts = counts()
    cycles = info["cycles"]
    cfg = solver.config
    # a varying level's visit: two legs of K4 (the pre-smoothing from zero
    # with the residual, the post-smoothing), split by kernels.leg_depth
    legs = legs_per_cycle(cfg, h)
    varying_levels = sum(k == "varying" for k in kinds[:-1])
    if not info["converged"] or not info["final_norm"] < 1e-10:
        fail(f"diffusion solve did not converge: {info['residual_norms']}")
    if (varying_levels != 4 or cycles == 0
            or main_counts != {"K1": 0, "K2": 0, "K3": 0, "K5": 0,
                               "K4": legs * cycles}):
        fail(f"diffusion solve: launches {main_counts} for {cycles} cycles, "
             f"{varying_levels} varying levels, {legs} K4 launches a cycle")
    hi, lo = info["x_df"]
    if not bool(torch.isfinite(hi).all() and torch.isfinite(lo).all()):
        fail("diffusion solution is not finite")
    x64 = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
    rn64 = residual_norm_host_stencil(
        offsets, coeffs, b.cpu().numpy().astype(np.float64), x64)
    if not rn64 < 2e-10:
        fail(f"diffusion: float64 residual of the merged pair is {rn64:.3e}")

    torch.cuda.reset_peak_memory_stats()
    x2, info2 = solver.solve(b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(x2, x):
        fail("two diffusion solves of the same system differ")
    del x2
    # a cycle's two parts, by CUDA events
    bz = torch.zeros_like(b)
    vcycle_ms = time_ms(
        lambda: run_cycle(h, b, "v", cfg.pre_iterations, cfg.post_iterations,
                          cfg.smoother, cfg.omega), 3, warm=1)
    resid_ms = time_ms(
        lambda: solver_mod._residual_norm_df(
            h.fine_hi, h.fine_hi_lo, (b, bz), info["x_df"]), 3, warm=1)
    del coeffs, x64, bz

    # the (32,32,64) diffusion solve on the card against the CPU
    small = (32, 32, 64)
    scfg = mg.SolverConfig(**{**DIFFUSION_CFG, "gridlevels": 3,
                              "max_dense_coarse": 1024})
    sst = mg.diffusion_stencil(medium(small))
    bs = mg.rhs_random(small, seed=0)
    bs /= np.linalg.norm(bs.ravel())
    xg, ig = mg.solve(sst, bs, scfg, device=dev)
    xc, ic = mg.solve(sst, bs, scfg, device="cpu")
    # both are within the threshold of one exact solution: ‖Δx‖ ≤ 2e-10/λ_min,
    # and λ_min(A) ≥ min κ · λ_min(Poisson) for the diffusion operator
    lam_min = 0.5 * sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in small)
    dx = float(np.linalg.norm((xg - xc).ravel()))
    if not (ig["converged"] and ig["cycles"] == ic["cycles"]
            and dx <= 2e-10 / lam_min):
        fail(f"small diffusion solve: card {ig['cycles']} cycles, CPU "
             f"{ic['cycles']}, |dx| = {dx:.3e}")

    # mg_solve with a scipy matrix: the fine level is detected constant (K1,
    # K2), the Galerkin level below it is stored as coefficient grids (K4)
    mshape = (64,) * 3
    mlegs = legs_per_visit(cfg, 27, 32 ** 3)
    A = mg.poisson(mshape)
    bm = mg.rhs_random(mshape, seed=3)
    bm /= np.linalg.norm(bm.ravel())
    zero_counts()
    xm, im = mg.mg_solve(A, bm.ravel(), {
        "problemshape": mshape, "transfer": "linear", "max_dense_coarse": 4096,
    })
    m_counts = counts()
    rm = float(np.linalg.norm(bm.ravel() - A @ xm))
    mc = im["cycles"]
    # 64³ → 32³ → 16³ (dense): one constant and one varying level
    if not (im["converged"] and rm < 1e-10 * 1.05 and mc > 0
            and m_counts == {"K1": 2 * mc, "K2": mc, "K3": 0,
                             "K4": mlegs * mc, "K5": 0}):
        fail(f"matrix mg_solve: converged={im['converged']} residual {rm:.3e} "
             f"launches {m_counts} for {mc} cycles")

    # float32 outer residual: one K3 launch per residual, cycles + 1 of them
    pcfg = dict(smoother="rbgs", transfer="linear", residual_dtype="float32",
                max_dense_coarse=4096, threshold=F32_THRESHOLD)
    big = BIG
    psolver = mg.setup(big, mg.SolverConfig(**pcfg), device=dev)
    zero_counts()
    xf, i32 = psolver.solve(b)
    torch.cuda.synchronize()
    f_counts = counts()
    fc = i32["cycles"]
    if not (i32["converged"] and fc > 0 and xf.dtype == torch.float32
            and f_counts == {"K1": 8 * fc, "K2": 0, "K3": fc + 1, "K4": 0,
                             "K5": 0}):
        fail(f"float32 residual solve: {i32['residual_norms']} launches "
             f"{f_counts} for {fc} cycles")
    t32 = time.perf_counter()
    _, i32b = psolver.solve(b)
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t32
    del xf, psolver
    spcfg = mg.SolverConfig(**{**pcfg, "gridlevels": 3, "max_dense_coarse": 1024})
    _, jg = mg.solve(small, bs, spcfg, device=dev)
    _, jc = mg.solve(small, bs, spcfg, device="cpu")
    if not (jg["converged"] and jg["cycles"] == jc["cycles"]):
        fail(f"small float32-residual solve: card {jg['cycles']} cycles, "
             f"CPU {jc['cycles']}")

    # the public residual and smooth with CUDA tensors: they launch the
    # kernels (never tensor code) and agree with the CPU
    hp = mg.setup(small, scfg, device=dev).hierarchy
    hpc = mg.setup(small, scfg, device="cpu").hierarchy
    hv = mg.setup(sst, scfg, device=dev).hierarchy
    hvc = mg.setup(sst, scfg, device="cpu").hierarchy
    direct = []
    for what, L, Lc, want_res, want_smooth in (
        ("constant", hp.levels[0], hpc.levels[0], {"K3": 1}, {"K1": 1}),
        ("cornered", hp.levels[1], hpc.levels[1], {"K3": 1}, {"K1": 1}),
        ("varying", hv.levels[0], hvc.levels[0], {"K4": 1}, {"K4": 4}),
    ):
        bb = randn(L.grid_shape, 21, dev)
        xx = randn(L.grid_shape, 22, dev)
        for fn_name, call, want in (
            ("residual", lambda l, b_, x_: stencil.residual(l.A, b_, x_), want_res),
            ("smooth", lambda l, b_, x_: smoothers.smooth(
                "rbgs", l.A, l.inv_diag, b_, x_, 2, OMEGA), want_smooth),
        ):
            zero_counts()
            got = call(L, bb, xx)
            torch.cuda.synchronize()
            moved = {k: v for k, v in counts().items() if v}
            ref = call(Lc, bb.cpu(), xx.cpu())
            err = float((got.cpu() - ref).abs().max())
            tol = 5e-6 * float((bb if fn_name == "residual" else ref).abs().max())
            if moved != want or not err <= tol:
                fail(f"{fn_name} on a {what} operator: launches {moved} "
                     f"(expected {want}), err {err:.3e} (tolerance {tol:.3e})")
            direct.append({"operator": what, "function": fn_name,
                           "launches": moved, "max_abs_err": err,
                           "tolerance": tol})

    # a float64 cycle on a varying hierarchy is refused on the card
    try:
        run_cycle(hv, randn(small, 23, dev).double())
    except NotImplementedError:
        refused = ["float64 cycle on varying levels"]
    else:
        fail("a float64 cycle ran on the card without a kernel")

    k = max(info2["cycles"], 1)
    emit("solve_vary", {
        "shape": list(shape), "levels": [list(s[0]) for s in h.stats],
        "taps": [s[1] for s in h.stats], "level_kinds": kinds,
        "cycles": cycles, "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn64,
        "launches": main_counts,
        "k4_launches_per_cycle": legs,
        "k4_launches_per_cycle_before": varying_levels * (
            2 * (cfg.pre_iterations + cfg.post_iterations) + 1),
        "k4_launches_per_level_visit": {
            "x".join(map(str, L.grid_shape)): legs_per_visit(
                cfg, len(L.A.offsets), int(np.prod(L.grid_shape)))
            for L in h.levels[:-1] if not L.A.is_constant},
        "stencil_s": t_stencil, "setup_s": t_setup,
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms": info2["solve_time_s"] * 1e3,
        "ms_per_cycle": info2["solve_time_s"] * 1e3 / k,
        "v_cycle_ms": vcycle_ms, "outer_residual_ms": resid_ms,
        "outer_residuals_per_solve": info2["cycles"] + 1,
        "peak_memory_MB": peak / 2 ** 20,
        "small_solve": {"shape": list(small), "cycles_card": ig["cycles"],
                        "cycles_cpu": ic["cycles"], "dx_norm": dx,
                        "dx_bound": 2e-10 / lam_min},
        "mg_solve_matrix": {"shape": list(mshape), "cycles": mc,
                            "residual_float64": rm, "launches": m_counts},
        "float32_residual_solve": {
            "shape": list(big), "threshold": F32_THRESHOLD, "cycles": fc,
            "residual_norms": i32["residual_norms"], "launches": f_counts,
            "solve_ms": t32 * 1e3, "cycles_warm": i32b["cycles"],
            "small": {"shape": list(small), "cycles_card": jg["cycles"],
                      "cycles_cpu": jc["cycles"]}},
        "direct_calls": direct,
        "refused_on_card": refused,
    })
    return main_counts, f_counts


def setup_unfaced(dev):
    """The 256³ Poisson solver with ``faced=False``: its coarse levels are
    coefficient grids (varying), not cornered tables."""
    import openmg_tpu_torch as mg

    cfg = mg.SolverConfig(**DIFFUSION_CFG, cycles=60)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = mg.setup(BIG, cfg, faced=False, device=dev)
    torch.cuda.synchronize()
    return solver, time.perf_counter() - t0


def phase_solve_unfaced(dev, unfaced, faced_cycles, faced_rn64):
    """The 256³ Poisson solve on the unfaced hierarchy: the constant fine
    level by K1 and K2, every varying coarse level by K4 legs (no K1
    there); the same cycle count as the faced solve."""
    import openmg_tpu_torch as mg

    solver, t_setup = unfaced
    h = solver.hierarchy
    kinds = ["const" if L.A.is_constant else "varying" for L in h.levels]
    bnp = mg.rhs_random(BIG, seed=1)
    bnp /= np.linalg.norm(bnp.ravel())
    b = torch.from_numpy(bnp.astype(np.float32)).to(dev)
    zero_counts()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    got = counts()
    cycles = info["cycles"]
    legs = legs_per_cycle(solver.config, h)
    varying = sum(k == "varying" for k in kinds[:-1])
    if kinds[0] != "const" or varying != h.num_levels - 2:
        fail(f"unfaced hierarchy: level kinds {kinds}")
    if not info["converged"] or cycles != faced_cycles:
        fail(f"unfaced solve: {cycles} cycles (faced: {faced_cycles}), "
             f"{info['residual_norms']}")
    want = {"K1": 2 * cycles, "K2": cycles, "K3": 0, "K4": legs * cycles,
            "K5": 0}
    if got != want:
        fail(f"unfaced solve: launches {got}, expected {want}")
    hi, lo = info["x_df"]
    x64 = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
    rn64 = residual_norm_host(b.cpu().numpy().astype(np.float64), x64)
    if not rn64 < 1e-10:
        fail(f"unfaced solve: float64 residual {rn64:.3e}")
    torch.cuda.reset_peak_memory_stats()
    _, info2 = solver.solve(b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("solve_unfaced", {
        "shape": list(BIG), "levels": [list(st[0]) for st in h.stats],
        "level_kinds": kinds, "cycles": cycles, "cycles_faced": faced_cycles,
        "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn64, "residual_float64_host_faced": faced_rn64,
        "launches": got, "k4_launches_per_cycle": legs,
        "setup_s": t_setup, "solve_ms": info2["solve_time_s"] * 1e3,
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "peak_memory_MB": peak / 2 ** 20,
        "coefficient_grids_MB": sum(
            L.A.coeffs.numel() * 4 for L in h.levels if not L.A.is_constant
        ) / 2 ** 20,
    })
    return got


# ---------------------------------------------------------------------------
# the 2D path: K5, and K2/K3 on 2D operands
# ---------------------------------------------------------------------------

BIG2 = (4096, 4096)  # the full-width 2D grid


def k5_modes(op, tr, ec, transfers=True):
    """name -> (callable on (impl, b, x), start from x?, kinds of outputs)."""
    from openmg_tpu_torch.ops import fused

    V, O = op.values, op.offsets
    corner = fused._corner_info(op)
    rb4 = fused.stages_for("rbgs", 2, OMEGA)

    def make(stages, **kw):
        return lambda impl, bb, xx: impl(V, O, bb, xx, stages, corner=corner, **kw)

    modes = {
        "4 rb stages on x": (make(rb4), True, ("x",)),
        "zero start, 4 rb stages, residual": (
            make(rb4, emit_residual=True), False, ("x", "r")),
        "6 jacobi stages on x, residual": (
            make(fused.stages_for("jacobi", 6, OMEGA), emit_residual=True),
            True, ("x", "r")),
    }
    if transfers:
        modes = {
            "down: zero start, 4 rb stages, restrict": (
                make(rb4, emit_residual=True, restrict_transfer=tr), False,
                ("x", "r")),
            # the down-leg of a W-cycle's second visit and of every FMG level
            "down: from x, 4 rb stages, restrict": (
                make(rb4, emit_residual=True, restrict_transfer=tr), True,
                ("x", "r")),
            "up: x + P ec, 4 rb stages": (
                make(rb4, ec=ec, prolong_transfer=tr), True, ("x",)),
            "down: zero start, 4 jacobi stages, restrict": (
                make(fused.stages_for("jacobi", 4, OMEGA), emit_residual=True,
                     restrict_transfer=tr), False, ("x", "r")),
            **modes,
        }
    return modes


def k5_bound(mode, n, nc, K):
    """(bytes, flops) the mode needs at n fine and nc coarse points: each
    array read or written once (a red/black stage computes at half the
    points)."""
    stage_rb = n / 2 * 2 * K
    stage_j = n * (2 * K + 3)
    resid = n * 2 * K
    restr = nc * 2 * 9
    if mode.startswith("down: zero start, 4 rb"):
        return 4 * (2 * n + nc), 4 * stage_rb + resid + restr
    if mode.startswith("down: from x"):
        return 4 * (3 * n + nc), 4 * stage_rb + resid + restr
    if mode.startswith("down"):
        return 4 * (2 * n + nc), 4 * stage_j + resid + restr
    if mode.startswith("up"):
        return 4 * (3 * n + nc), 4 * stage_rb + n * 8
    if mode.startswith("4 rb"):
        return 4 * 3 * n, 4 * stage_rb
    if mode.startswith("zero start"):
        return 4 * 3 * n, 4 * stage_rb + resid
    return 4 * 4 * n, 6 * stage_j + resid


def phase_fused2d(dev, copy_bw):
    """K5 against its plain version in every mode the V-cycle uses; the K2
    lift bit for bit; K3's residual on a cornered 2D level against the
    CPU."""
    import dataclasses

    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import doublefloat as df
    from openmg_tpu_torch.ops import kernels, stencil
    from openmg_tpu_torch.ops.stencil import StencilOperator, apply

    reps, plain_reps = 12, 3
    cfg = mg.SolverConfig(**DIFFUSION_CFG)
    h = mg.setup(BIG2, cfg, device=dev).hierarchy
    h_odd = mg.setup((200, 328), mg.SolverConfig(
        **{**DIFFUSION_CFG, "gridlevels": 4, "max_dense_coarse": 4096}),
        device=dev).hierarchy
    op37 = StencilOperator(
        None, mg.models.poisson.poisson_offsets(2),
        torch.tensor([4.0, -1, -1, -1, -1], dtype=torch.float32, device=dev),
        (37, 91))
    tr = h.transfer
    # the two legs a V(2,2) cycle launches on every cornered level
    legs = ("down: zero start, 4 rb", "up")
    # (tag, operator, timed modes: None = none, True = all, else prefixes)
    cases = [
        ("main 4096^2", h.levels[0].A, True),
        ("main 2048^2", h.levels[1].A, legs + ("down: from x",)),
        ("main 1024^2", h.levels[2].A, legs),
        ("main 512^2", h.levels[3].A, legs),
        ("main 256^2", h.levels[4].A, legs),
        ("main 128^2", h.levels[5].A, legs),
        ("odd 200x328", h_odd.levels[0].A, None),
        ("odd 100x164", h_odd.levels[1].A, None),
        ("no transfer 37x91", op37, None),
    ]
    rows = []
    for tag, op, timed in cases:
        shape = op.grid_shape
        n = int(np.prod(shape))
        cshape = tuple(s // 2 for s in shape)
        nc = int(np.prod(cshape))
        kind = "const" if op.is_constant else "cornered"
        b = randn(shape, 31, dev)
        x = randn(shape, 32, dev)
        ec = randn(cshape, 33, dev)
        modes = k5_modes(op, tr, ec, transfers=tag != "no transfer 37x91")
        for mode, (call, has_x, outs) in modes.items():
            xin = x if has_x else None
            before = kernels.LAUNCHES_K5
            got = call(kernels.fused_stages_2d, b, xin)
            torch.cuda.synchronize()
            if kernels.LAUNCHES_K5 - before != 1:
                fail(f"K5 {tag} {mode}: {kernels.LAUNCHES_K5 - before} launches")
            ref = call(kernels.fused_stages_2d_plain, b, xin)
            torch.cuda.synchronize()
            worst, errs = check_outputs(f"K5 {mode} {kind} {shape}", outs, got, ref, b)
            del got, ref
            row = {"level": tag, "kind": kind, "shape": list(shape),
                   "taps": len(op.offsets), "mode": mode, "errors": errs,
                   "max_abs_err": worst}
            if timed is True or (timed and mode.startswith(timed)):
                row.update(timings(
                    lambda: call(kernels.fused_stages_2d, b, xin),
                    lambda: call(kernels.fused_stages_2d_plain, b, xin),
                    *k5_bound(mode, n, nc, len(op.offsets)), copy_bw, reps,
                    plain_reps), library_ms=None)
                if kind == "const" and mode == "zero start, 4 rb stages, residual":
                    # A x as one library call: the residual mode's yardstick
                    lib_ms, ax = conv_ms(op, x, reps)
                    lib_err = float((ax - apply(op, x)).abs().max())
                    if lib_err > 2e-6 * float(x.abs().max()) * 8:
                        fail(f"conv2d yardstick disagrees: {lib_err:.3e}")
                    row.update(library_ms=lib_ms, library="F.conv2d 3x3, zero "
                               "padding, TF32 off (computes A x only)")
                    del ax
            rows.append(row)
        del b, x, ec
        torch.cuda.empty_cache()

    # K2 on a 2D grid: lifted to (1, ny, nx), bit for bit
    offs = h.fine_hi.offsets
    terms = tuple(df.pow2_terms(float(v)) for v in h.fine_hi.values.cpu().numpy())
    rng = np.random.default_rng(35)
    xh, xl = df.df_split(rng.standard_normal(BIG2), dev)
    bh, bl = df.df_split(rng.standard_normal(BIG2), dev)
    e = randn(BIG2, 36, dev, scale=1e-3)
    got = kernels.df_update_residual_const_3d(offs, terms, xh, xl, e, bh, bl, emit_norm=True)
    ref = kernels.df_update_residual_const_3d_plain(offs, terms, xh, xl, e, bh, bl, emit_norm=True)
    torch.cuda.synchronize()
    for name, g, r in zip(("x_hi", "x_lo", "r_hi"), got, ref):
        if not torch.equal(g, r):
            fail(f"K2 lift {BIG2}: {name} differs from the plain version")
    have, want = float(torch.sum(got[3])), float(torch.sum(ref[2] * ref[2]))
    if abs(have - want) > 1e-6 * want:
        fail(f"K2 lift: partial sums {have!r} vs {want!r}")
    k2_row = {
        "shape": list(BIG2), "bit_equal": True, "max_abs_err": 0.0,
        "norm_rel_err": abs(have - want) / want, "partials": int(got[3].numel()),
        **timings(
            lambda: kernels.df_update_residual_const_3d(
                offs, terms, xh, xl, e, bh, bl, emit_norm=True),
            lambda: kernels.df_update_residual_const_3d_plain(
                offs, terms, xh, xl, e, bh, bl, emit_norm=True),
            *k2_bound(int(np.prod(BIG2)), terms, True), copy_bw, reps,
            plain_reps),
    }
    del got, ref, xh, xl, bh, bl, e

    # K3 on the cornered 2048² level: one launch of the lifted region table,
    # against the CPU's plain tensor code
    A1 = h.levels[1].A
    b1, x1 = randn(A1.grid_shape, 37, dev), randn(A1.grid_shape, 38, dev)
    before = kernels.LAUNCHES_K3
    r1 = stencil.residual(A1, b1, x1)
    torch.cuda.synchronize()
    k3_launches = kernels.LAUNCHES_K3 - before
    A1c = dataclasses.replace(A1, values=A1.values.cpu(), deltas=A1.deltas.cpu())
    r1c = stencil.residual(A1c, b1.cpu(), x1.cpu())
    k3_err = float((r1.cpu() - r1c).abs().max())
    k3_tol = SWEEP_TOL * float(b1.abs().max())
    if k3_launches != 1 or not k3_err <= k3_tol:
        fail(f"K3 cornered 2D residual: {k3_launches} launches, err {k3_err:.3e} "
             f"(tolerance {k3_tol:.3e})")
    del b1, x1, r1, r1c, h, h_odd
    torch.cuda.empty_cache()

    emit("fused2d", {
        "K5": rows, "K2_lift": k2_row,
        "K3_cornered_2d": {"shape": list(A1.grid_shape), "launches": k3_launches,
                           "max_abs_err": k3_err, "tolerance": k3_tol},
        "tolerance": "2e-6*max|ref| (x), 2e-6*max|b| (r, bc); K2 bit-equal",
        "timed_launches": reps,
    })
    return rows, k2_row


def phase_solve_2d(dev):
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import smoothers, stencil

    cfg = mg.SolverConfig(**DIFFUSION_CFG, cycles=60)
    t0 = time.perf_counter()
    solver = mg.setup(BIG2, cfg, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    h = solver.hierarchy
    bnp = mg.rhs_random(BIG2, seed=1)
    bnp /= np.linalg.norm(bnp.ravel())
    b = torch.from_numpy(bnp.astype(np.float32)).to(dev)
    for L in h.levels[1:-1]:
        A = L.A
        if not (hasattr(A, "table") and A.table.is_cuda and A.values.is_cuda):
            fail("a 2D coarse level is not cornered with its table on the card")

    # the main path of this slice, with the launch counts read around it
    zero_counts()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    main_counts = counts()
    cycles = info["cycles"]
    visited = h.num_levels - 1
    if h.num_levels != 7 or not info["converged"] or cycles > 8 or cycles == 0:
        fail(f"2D solve: {h.num_levels} levels, {info['residual_norms']}")
    if main_counts != {"K1": 0, "K2": cycles, "K3": 0, "K4": 0,
                       "K5": 2 * visited * cycles}:
        fail(f"2D solve: launches {main_counts} for {cycles} cycles, "
             f"{visited} visited levels")
    hi, lo = info["x_df"]
    if not (tuple(x.shape) == BIG2 and x.dtype == torch.float32 and x.is_cuda
            and bool(torch.isfinite(hi).all() and torch.isfinite(lo).all())):
        fail("2D solve did not deliver a finite float32 tensor on the card")
    x64 = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
    rn64 = residual_norm_host(bnp.astype(np.float32).astype(np.float64), x64)
    if not rn64 < 2e-10:
        fail(f"2D solve: float64 residual of the merged pair is {rn64:.3e}")
    torch.cuda.reset_peak_memory_stats()
    x2, info2 = solver.solve(b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(x2, x):
        fail("two 2D solves of the same system differ")
    del x, x2, x64, hi, lo, solver, h
    torch.cuda.empty_cache()

    # BASELINE config 2: 2D Poisson 256², five levels, red-black GS; on the
    # card and on the CPU (plain versions)
    cshape = (256, 256)
    ccfg = mg.SolverConfig(**{**DIFFUSION_CFG, "gridlevels": 5,
                              "max_dense_coarse": 4096})
    bc = mg.rhs_random(cshape, seed=0)
    bc /= np.linalg.norm(bc.ravel())
    xg, ig = mg.solve(cshape, bc, ccfg, device=dev)
    xc, ic = mg.solve(cshape, bc, ccfg, device="cpu")
    lam_min = sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in cshape)
    dx = float(np.linalg.norm((xg - xc).ravel()))
    dx_max = float(np.abs(xg - xc).max())
    if not (ig["converged"] and ig["cycles"] == ic["cycles"]
            and dx <= 2e-10 / lam_min):
        fail(f"BASELINE config 2: card {ig['cycles']} cycles, CPU "
             f"{ic['cycles']}, |dx| = {dx:.3e}")

    # mg_solve with a scipy matrix: the fine level is detected constant (K5,
    # K2), the Galerkin levels below it are coefficient grids (K4 lifted)
    mshape = (512, 512)
    A = mg.poisson(mshape)
    bm = mg.rhs_random(mshape, seed=3)
    bm /= np.linalg.norm(bm.ravel())
    zero_counts()
    xm, im = mg.mg_solve(A, bm.ravel(), {
        "problemshape": mshape, "transfer": "linear", "max_dense_coarse": 4096,
    })
    m_counts = counts()
    rm = float(np.linalg.norm(bm.ravel() - A @ xm))
    mc = im["cycles"]
    # 512² → 256² → 128² → 64² (dense): one constant and two varying
    # (9-point) levels
    legs = legs_per_visit(cfg, 9, 256 ** 2) + legs_per_visit(cfg, 9, 128 ** 2)
    if not (im["converged"] and rm < 1e-10 * 1.05 and mc > 0
            and m_counts == {"K1": 0, "K2": mc, "K3": 0, "K4": legs * mc,
                             "K5": 2 * mc}):
        fail(f"2D matrix mg_solve: converged={im['converged']} residual "
             f"{rm:.3e} launches {m_counts} for {mc} cycles")

    # a 2D stencil pair (variable-coefficient diffusion) against the CPU
    dshape = (256, 512)
    dst = mg.diffusion_stencil(medium(dshape))
    bd = mg.rhs_random(dshape, seed=4)
    bd /= np.linalg.norm(bd.ravel())
    xdg, idg = mg.solve(dst, bd, mg.SolverConfig(**DIFFUSION_CFG), device=dev)
    xdc, idc = mg.solve(dst, bd, mg.SolverConfig(**DIFFUSION_CFG), device="cpu")
    dlam = 0.5 * sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in dshape)
    ddx = float(np.linalg.norm((xdg - xdc).ravel()))
    if not (idg["converged"] and idg["cycles"] == idc["cycles"]
            and ddx <= 2e-10 / dlam):
        fail(f"2D diffusion: card {idg['cycles']} cycles, CPU {idc['cycles']}, "
             f"|dx| = {ddx:.3e}")

    # float32 outer residual at 1024²: one K3 launch per residual
    fshape = (1024, 1024)
    fsolver = mg.setup(fshape, mg.SolverConfig(
        smoother="rbgs", transfer="linear", residual_dtype="float32",
        max_dense_coarse=4096, threshold=F32_THRESHOLD_2D), device=dev)
    bf = mg.rhs_random(fshape, seed=5)
    bf /= np.linalg.norm(bf.ravel())
    zero_counts()
    xf, i32 = fsolver.solve(torch.from_numpy(bf.astype(np.float32)).to(dev))
    torch.cuda.synchronize()
    f_counts = counts()
    fc = i32["cycles"]
    fvis = fsolver.hierarchy.num_levels - 1
    if not (i32["converged"] and fc > 0 and xf.dtype == torch.float32
            and f_counts == {"K1": 0, "K2": 0, "K3": fc + 1, "K4": 0,
                             "K5": 2 * fvis * fc}):
        fail(f"2D float32-residual solve: {i32['residual_norms']} launches "
             f"{f_counts} for {fc} cycles")
    del xf, fsolver

    # residual and smooth with CUDA tensors on a cornered 2D operator
    hp = mg.setup(cshape, ccfg, device=dev).hierarchy
    hpc = mg.setup(cshape, ccfg, device="cpu").hierarchy
    L, Lc = hp.levels[1], hpc.levels[1]
    bb, xx = randn(L.grid_shape, 41, dev), randn(L.grid_shape, 42, dev)
    direct = []
    for fn_name, call, want in (
        ("residual", lambda l, b_, x_: stencil.residual(l.A, b_, x_), {"K3": 1}),
        ("smooth", lambda l, b_, x_: smoothers.smooth(
            "rbgs", l.A, l.inv_diag, b_, x_, 2, OMEGA), {"K5": 1}),
    ):
        zero_counts()
        got = call(L, bb, xx)
        torch.cuda.synchronize()
        moved = {k: v for k, v in counts().items() if v}
        ref = call(Lc, bb.cpu(), xx.cpu())
        err = float((got.cpu() - ref).abs().max())
        tol = 5e-6 * float((bb if fn_name == "residual" else ref).abs().max())
        if moved != want or not err <= tol:
            fail(f"{fn_name} on a cornered 2D operator: launches {moved} "
                 f"(expected {want}), err {err:.3e} (tolerance {tol:.3e})")
        direct.append({"operator": "cornered 2D", "function": fn_name,
                       "launches": moved, "max_abs_err": err, "tolerance": tol})

    # a 1D grid sets up on the card (its solves are the solve_1d phase's)
    s1 = mg.setup((4096,), ccfg, device=dev)
    if s1.hierarchy.device != dev or s1.hierarchy.grid_shape != (4096,):
        fail("a 1D setup did not land on the card")
    runs_1d = {"shape": [4096], "levels": [list(st[0]) for st in s1.hierarchy.stats]}
    del s1

    k = max(info2["cycles"], 1)
    emit("solve_2d", {
        "shape": list(BIG2), "levels": [list(s[0]) for s in info["level_stats"]],
        "cycles": cycles, "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn64, "launches": main_counts,
        "setup_s": t_setup,
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms": info2["solve_time_s"] * 1e3,
        "ms_per_cycle": info2["solve_time_s"] * 1e3 / k,
        "peak_memory_MB": peak / 2 ** 20,
        "baseline_config_2": {
            "shape": list(cshape), "gridlevels": 5, "cycles_card": ig["cycles"],
            "cycles_cpu": ic["cycles"], "final_norm_card": ig["final_norm"],
            "dx_norm": dx, "dx_max": dx_max, "dx_bound": 2e-10 / lam_min},
        "mg_solve_matrix": {"shape": list(mshape), "cycles": mc,
                            "residual_float64": rm, "launches": m_counts},
        "diffusion": {"shape": list(dshape), "cycles_card": idg["cycles"],
                      "cycles_cpu": idc["cycles"], "dx_norm": ddx,
                      "dx_bound": 2e-10 / dlam},
        "float32_residual_solve": {
            "shape": list(fshape), "threshold": F32_THRESHOLD_2D, "cycles": fc,
            "residual_norms": i32["residual_norms"], "launches": f_counts},
        "direct_calls": direct,
        "setup_1d_on_card": runs_1d,
    })
    return main_counts


# ---------------------------------------------------------------------------
# the general sparse engine: K6 (slot-offset ELL SpMV), K7 (blocked-band BSR)
# ---------------------------------------------------------------------------

# the H100 SXM data sheet's float64 rate outside the tensor cores
PEAK_F64_FLOPS = 34e12
SPARSE_TOL = 2e-6
ELL_SHAPE = (1024, 1024)
ELL_PARAMS = {"problemshape": ELL_SHAPE, "format": "ell", "transfer": "linear",
              "smoother": "rbgs", "max_dense_coarse": 4096, "threshold": 1e-10}
BSR_SHAPE = (64, 64, 64)
BSR_CFG = dict(format="bsr", blocksize=4, smoother="jacobi", transfer="linear",
               max_dense_coarse=4096, cycles=200, threshold=1e-10)


def sparse_counts():
    from openmg_tpu_torch.ops import bsr, ell

    return {"K6": ell.LAUNCHES_K6, "K7": bsr.LAUNCHES_K7}


def setup_sparse_solvers(dev):
    """The two full-width sparse solvers, set up once: the 1024² Poisson
    ELL hierarchy with the settings ``mg_solve`` reads from ``ELL_PARAMS``,
    and the 64³ coupled-diffusion BSR hierarchy (B = 4).  Host seconds."""
    import openmg_tpu_torch as mg

    t0 = time.perf_counter()
    ell_solver = mg.setup_sparse(
        mg.poisson(ELL_SHAPE), ELL_SHAPE,
        mg.SolverConfig.from_parameters(ELL_PARAMS), device=dev,
    )
    t_ell = time.perf_counter() - t0
    A_bsr = mg.coupled_diffusion(BSR_SHAPE, 4)
    t0 = time.perf_counter()
    bsr_solver = mg.setup_sparse(
        A_bsr, BSR_SHAPE, mg.SolverConfig(**BSR_CFG), dofs=4, device=dev
    )
    torch.cuda.synchronize()
    t_bsr = time.perf_counter() - t0
    return {"ell": ell_solver, "ell_setup_s": t_ell, "bsr": bsr_solver,
            "bsr_matrix": A_bsr, "bsr_setup_s": t_bsr}


def library_csr(M):
    """The true nonzeros of a banded ELL or BSR container as a
    ``torch.sparse`` CSR matrix on its device (the yardstick's operand)."""
    from openmg_tpu_torch.ops import sparse

    n = M.shape[0]
    dev = M.data.device
    r = torch.arange(n, device=dev)
    rows, cols, vals = [], [], []
    # (column, values) of each slot's plane, and where the column exists
    if isinstance(M, sparse.ELLMatrix):
        planes = [(r + int(d), M.data[j]) for j, d in enumerate(M.slot_offsets)]
    else:
        B = M.blocksize[0]
        planes = [((r // B + int(d)) * B + j, M.data[s, j])
                  for s, d in enumerate(M.slot_offsets) for j in range(B)]
    for c, v in planes:
        live = (v != 0) & (c >= 0) & (c < n)
        rows.append(r[live])
        cols.append(c[live])
        vals.append(v[live])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    A = torch.sparse_coo_tensor(idx, torch.cat(vals), (n, n)).coalesce()
    return A.to_sparse_csr()


def spmv_check(kernel, case, M, seed, copy_bw, reps=20):
    """One K6 or K7 case: the kernel against its plain version on the same
    card tensors (bit for bit, or within SPARSE_TOL · max_i Σ |terms|), the
    kernel's, the plain version's and ``torch.mv`` on the true nonzeros'
    device times, each call on another copy of the operands (``device_ms``;
    ``ms_l2_warm`` is the kernel called again on one copy, which finds in
    L2 what fits there, and ``ms_host_paced`` the kernel by ``time_ms``,
    which counts the wrapper's host cost where that is longer than the
    kernel), and the bound."""
    from openmg_tpu_torch.ops import bsr, ell

    n = M.shape[0]
    x = randn((n,), seed, M.data.device).to(M.dtype)
    if M.slot_offsets is None:
        fail(f"{kernel} {case}: the container is not banded")
    if kernel == "K6":
        spmv = ell.spmv_ell

        def plain_of(Mc, xc):
            return ell.spmv_banded_plain(Mc.data, Mc.slot_offsets, xc)

        width = {"k": M.k}
    else:
        spmv, plain_of = bsr.spmv_bsr, bsr.spmv_banded_plain
        width = {"kb": M.kb, "B": M.blocksize[0]}
    run = functools.partial(spmv, M, x)
    terms = plain_of(dataclasses.replace(M, data=M.data.abs()), x.abs())
    got, ref = run(), plain_of(M, x)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        fail(f"{kernel} {case}: bad output")
    scale = float(terms.max())
    err = float((got - ref).abs().max())
    if not err <= SPARSE_TOL * scale:
        fail(f"{kernel} {case}: err {err:.3e} > {SPARSE_TOL * scale:.3e}")
    A = library_csr(M)
    lib = torch.mv(A, x)
    lib_err = float((lib - ref).abs().max())
    if not lib_err <= 1e-5 * scale:
        fail(f"{kernel} {case}: torch.mv differs by {lib_err:.3e}")
    es = M.data.element_size()
    nbytes = (M.data.numel() + 2 * n) * es
    flops = 2 * M.data.numel()
    peak = PEAK_F64_FLOPS if M.dtype == torch.float64 else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3
    # a copy of the operands for each call in a row, so that each call
    # reads them from device memory
    ops = [(M, x, A)] + [
        (Mc, x.clone(), library_csr(Mc)) for Mc in (
            dataclasses.replace(M, data=M.data.clone())
            for _ in range(operand_copies(nbytes) - 1))
    ]
    t = dict(
        ms=device_ms([functools.partial(spmv, Mc, xc) for Mc, xc, _ in ops]),
        plain_ms=device_ms(
            [functools.partial(plain_of, Mc, xc) for Mc, xc, _ in ops], 5),
        library_ms=device_ms([functools.partial(torch.mv, Ac, xc)
                              for _, xc, Ac in ops]),
        ms_l2_warm=device_ms([run]), ms_host_paced=time_ms(run, 20),
        operand_copies=len(ops),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bound_ms_copy_bw=nbytes / copy_bw * 1e3, bytes=nbytes, flops=flops,
    )
    t["ms_over_library"] = t["ms"] / t["library_ms"]
    if kernel == "K7":
        t["lanes"] = bsr.lane_group(n, M.kb, M.blocksize[0])
    del A, ops
    return {"case": case, "shape": [n], "mode": case, **width,
            "dtype": str(M.dtype).replace("torch.", ""),
            "bit_equal": bool(torch.equal(got, ref)), "max_abs_err": err,
            "tolerance": SPARSE_TOL * scale, "library_max_abs_err": lib_err,
            **t}


def phase_spmv(dev, copy_bw, solvers):
    """K6 and K7 against their plain versions on the card at every shape
    of the sparse solves' main paths and at the edge cases."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import sparse

    he, hb = solvers["ell"].hierarchy, solvers["bsr"].hierarchy
    ell_shape = "x".join(map(str, ELL_SHAPE))
    bsr_shape = "x".join(map(str, BSR_SHAPE))
    p256 = mg.poisson_ell_device(BIG, device=dev)
    pads = sparse.ell_from_scipy(mg.poisson((64, 64)), k=7, device=dev)
    if pads.k != 7 or int((pads.data != 0).any(dim=1).sum()) != 5:
        fail("the padded ELL does not carry two empty slots")
    # every level of the two full-width hierarchies whose operator goes to
    # K6 or K7 (the coarsest is solved by its dense inverse), fine first
    main6 = [(f"{ell_shape} Poisson level {i} (k {L.A.k}), main path", L.A)
             for i, L in enumerate(he.levels[:-1])]
    main7 = [(f"{bsr_shape} coupled diffusion B=4 level {i} (kb {L.A.kb}), "
              "main path", L.A) for i, L in enumerate(hb.levels[:-1])]
    for what, main, want in (("ELL", main6, sparse.ELLMatrix),
                             ("BSR", main7, sparse.BSRMatrix)):
        if not all(isinstance(M, want) and M.slot_offsets is not None
                   for _, M in main):
            fail(f"a visited level of the {what} hierarchy is not banded")
    k6 = main6[:1] + [
        ("x".join(map(str, BIG)) + " Poisson, poisson_ell_device", p256),
    ] + main6[1:] + [
        ("(37, 91) Poisson, n % 32 != 0", sparse.ell_from_scipy(
            mg.poisson((37, 91)), device=dev)),
        ("64^2 Poisson with two pad slots", pads),
        ("64^3 Poisson, float64", sparse.ell_from_scipy(
            mg.poisson((64, 64, 64)), dtype=np.float64, device=dev)),
    ]
    k7 = main7 + [
        ("2D elasticity 256^2 B=2", sparse.bsr_from_scipy(
            mg.elasticity((256, 256)), blocksize=(2, 2), device=dev)),
        ("3D elasticity 24^3 B=3", sparse.bsr_from_scipy(
            mg.elasticity((24, 24, 24)), blocksize=(3, 3), device=dev)),
        ("Poisson 16^3 B=8", sparse.bsr_from_scipy(
            mg.poisson((16, 16, 16)), blocksize=(8, 8), device=dev)),
        ("coupled diffusion 16^3 B=4, float64", sparse.bsr_from_scipy(
            mg.coupled_diffusion((16, 16, 16), 4), blocksize=(4, 4),
            dtype=np.float64, device=dev)),
    ]
    rows = {"K6": [], "K7": []}
    for kernel, cases in (("K6", k6), ("K7", k7)):
        for i, (case, M) in enumerate(cases):
            rows[kernel].append(spmv_check(kernel, case, M, 40 + i, copy_bw))
    del p256
    emit("spmv", {
        "K6": rows["K6"], "K7": rows["K7"],
        "tolerance": f"bit-equal, or {SPARSE_TOL}*max_i sum|terms|",
        "library": "torch.mv on a torch.sparse CSR of the true nonzeros "
                   "(a yardstick; the port never calls it)",
    })
    return rows


def phase_batch_spmv(dev, copy_bw, solvers):
    """The batched K6 and K7 (``batch_kernels`` for K6b and K7b) at K = 8
    on the sparse solves' levels: K6b on the 1024² ELL level 0 (k 5) and
    level 1 (k 9), K7b on the 64³ B=4 level 0 (kb 7) and level 1 (kb 27).
    Each against its batched plain version (bit for bit by design, failing
    only beyond K6's and K7's tolerance) and member by member against the
    scalar launches bit for bit; device ms on operands cut beforehand
    (rotating copies, as ``spmv`` times K6 and K7) beside K scalar launches,
    ``torch.sparse.mm`` of the true nonzeros with an ``(n, K)`` block as a
    yardstick the port never calls, and the batched bound (the matrix
    once, K × x and y)."""
    from openmg_tpu_torch.ops import bsr, ell

    K = BATCH_K
    he, hb = solvers["ell"].hierarchy, solvers["bsr"].hierarchy
    cases = [("K6b", f"{ELL_SHAPE[0] >> i}^2 level {i} (k {L.A.k})", L.A)
             for i, L in enumerate(he.levels[:2])]
    cases += [("K7b", f"{BSR_SHAPE[0] >> i}^3 B=4 level {i} (kb {L.A.kb})", L.A)
              for i, L in enumerate(hb.levels[:2])]
    rows = {"K6b": [], "K7b": []}
    for kernel, case, M in cases:
        n = M.shape[0]
        if kernel == "K6b":
            batched, scalar = ell.spmv_ell_batch, ell.spmv_ell

            def plain(Mc, X):
                return ell.spmv_banded_batch_plain(Mc.data, Mc.slot_offsets, X)
        else:
            batched, scalar = bsr.spmv_bsr_batch, bsr.spmv_bsr
            plain = bsr.spmv_banded_batch_plain
        X = randn_card((K, n), 45, dev)
        got, ref = batched(M, X), plain(M, X)
        torch.cuda.synchronize()
        terms = plain(dataclasses.replace(M, data=M.data.abs()), X.abs())
        scale = float(terms.max())
        del terms
        err = float((got - ref).abs().max())
        if got.shape != ref.shape or not err <= SPARSE_TOL * scale:
            fail(f"{kernel} {case}: err {err:.3e} > {SPARSE_TOL * scale:.3e}")
        for m in range(K):
            if not torch.equal(got[m], scalar(M, X[m])):
                fail(f"{kernel} {case}: member {m} is not bit-equal to the "
                     "scalar launch")
        A = library_csr(M)
        lib = torch.sparse.mm(A, X.t().contiguous()).t()
        lib_err = float((lib - ref).abs().max())
        if not lib_err <= 1e-5 * scale:
            fail(f"{kernel} {case}: torch.sparse.mm differs by {lib_err:.3e}")
        es = M.data.element_size()
        nbytes = (M.data.numel() + 2 * K * n) * es
        flops = 2 * K * M.data.numel()
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        ops = [(M, X, A)] + [
            (Mc, X.clone(), library_csr(Mc)) for Mc in (
                dataclasses.replace(M, data=M.data.clone())
                for _ in range(operand_copies(nbytes) - 1))
        ]
        ms = device_ms([functools.partial(batched, Mc, Xc) for Mc, Xc, _ in ops])
        scalar_ms = device_ms([functools.partial(scalar, ops[m % len(ops)][0],
                                                 ops[m % len(ops)][1][m])
                               for m in range(K)], 2 * K)
        rows[kernel].append({
            "case": case, "K": K, "shape": [K, n], "mode": case,
            "bit_equal_to_plain": bool(torch.equal(got, ref)),
            "bit_equal_to_scalar_per_member": True, "max_abs_err": err,
            "tolerance": SPARSE_TOL * scale, "library_max_abs_err": lib_err,
            "ms": ms, "ms_per_member": ms / K, "scalar_ms": scalar_ms,
            "K_times_scalar_ms": K * scalar_ms,
            "batch_over_scalar": ms / (K * scalar_ms),
            "plain_ms": device_ms([functools.partial(plain, Mc, Xc)
                                   for Mc, Xc, _ in ops], 3),
            "library_ms": device_ms([functools.partial(torch.sparse.mm, Ac,
                                                       Xc.t().contiguous())
                                     for _, Xc, Ac in ops]),
            "library": "torch.sparse.mm(CSR of the true nonzeros, (n, K) block)",
            "operand_copies": len(ops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_copy_bw": nbytes / copy_bw * 1e3, "bytes": nbytes,
            "flops": flops,
        })
        del got, ref, lib, A, ops, X
        torch.cuda.empty_cache()
    emit("batch_kernels_k6k7", {
        "K": K, **rows,
        "tolerance": f"bit-equal, or {SPARSE_TOL}*max_i sum|terms|; every member "
                     "bit-equal to the scalar launch",
        "bound": "the matrix once, K x (x read and y written)",
    })
    return rows


def sparse_phases(solver, b, info):
    """A sparse solve's parts, each timed alone (``time_ms``, five calls,
    each between events after a synchronize): the
    double-float outer residual, one cycle, and on the fine level one
    smoothing sweep, the level residual, the restriction and the
    prolongation."""
    from openmg_tpu_torch.core import algebraic as alg
    from openmg_tpu_torch.ops.sparse import spmv

    h, cfg = solver.hierarchy, solver.config
    b_df = (b, torch.zeros_like(b))
    x_df = info["x_df"]
    r = alg._sparse_residual_df(h.fine_hi, h.fine_lo, b_df, x_df)[0][0]
    L0 = h.levels[0]
    x0 = torch.zeros_like(b)
    rc = alg._restrict_level(h, 0, r)
    return {
        "outer_residual": time_ms(
            lambda: alg._sparse_residual_df(h.fine_hi, h.fine_lo, b_df, x_df),
            5, warm=1),
        "cycle": time_ms(lambda: solver._cycle(r), 5, warm=1),
        "fine_smoothing_sweep": time_ms(
            lambda: alg._smooth_sparse(L0, b, x0, 1, cfg.smoother, cfg.omega),
            5, warm=1),
        "fine_level_residual": time_ms(lambda: b - spmv(L0.A, x0), 5, warm=1),
        "fine_restriction": time_ms(
            lambda: alg._restrict_level(h, 0, r), 5, warm=1),
        "fine_prolongation": time_ms(
            lambda: alg._prolong_level(h, 0, rc), 5, warm=1),
        "outer_residual_operator": "banded ELL" if h.fine_hi.slot_offsets
        is not None else "irregular ELL (gathered)",
        "transfers": "grid ops" if h.geom_transfer(0) else "ELL SpMV (gathered)",
    }


def profile_solve(solver, b, top=10):
    """Device time by kernel over one solve under ``torch.profiler`` (names
    cut to 70 characters and summed), the device's busy time and the
    number of device operations.  Run last: the profiler slows launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(b)
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
    return {
        "solve_ms_profiled": wall * 1e3,
        "device_busy_ms": sum(v["ms"] for v in by_kernel.values()),
        "device_operations": sum(v["count"] for v in by_kernel.values()),
        "kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]["ms"])[:top]),
    }


def lambda_min(A):
    import scipy.sparse.linalg as spla

    return float(spla.eigsh(A.tocsc(), k=1, sigma=0, which="LM",
                            return_eigenvectors=False)[0])


def sparse_pcg_fmg(dev, solvers, b_bsr, b_ell, bsr_cycles, ell_cycles):
    """The 64³ B=4 BSR solve with PCG(2) (K7 for every level product and
    for ``A p``) and the 1024² ELL solve with FMG (checks and times on the
    set-up hierarchy, then once through ``mg_solve``)."""
    import openmg_tpu_torch as mg

    h_bsr = solvers["bsr"].hierarchy
    A_bsr = solvers["bsr_matrix"]
    b64 = b_bsr.cpu().numpy().astype(np.float64)
    cfg = mg.SolverConfig(**BSR_CFG, **INNER_KW["pcg"])
    per_step = cfg.krylov_iters * 5 * (h_bsr.num_levels - 1) + cfg.krylov_iters
    pcg = card_solve(
        "BSR pcg", mg.AlgebraicSolver(h_bsr, cfg), b_bsr,
        lambda x64: float(np.linalg.norm(b64 - A_bsr @ x64)),
        lambda c: {"K7": per_step * c}, max_cycles=200)
    pcg.update(krylov=cfg.krylov, krylov_iters=cfg.krylov_iters,
               plain_v_cycles=bsr_cycles)
    h_ell = solvers["ell"].hierarchy
    A = mg.poisson(ELL_SHAPE)
    b64 = b_ell.cpu().numpy().astype(np.float64)
    params = dict(ELL_PARAMS, cycle_type="f")
    colors = tuple(lv.num_colors for lv in h_ell.levels)
    per_step = sum((lv + 1) * (1 + 4 * c) for lv, c in enumerate(colors[:-1]))
    fmg = card_solve(
        "ELL fmg", mg.AlgebraicSolver(h_ell, mg.SolverConfig.from_parameters(params)),
        b_ell, lambda x64: float(np.linalg.norm(b64 - A @ x64)),
        lambda c: {"K6": per_step * c})
    t0 = time.perf_counter()
    xm, im = mg.mg_solve(A, b_ell, params, device=dev)
    wall = time.perf_counter() - t0
    rm = float(np.linalg.norm(b64 - A @ xm.astype(np.float64)
                              - A @ im["x_df"][1].cpu().numpy().astype(np.float64)))
    if not (im["converged"] and im["cycles"] == fmg["cycles"] and rm < 2e-10):
        fail(f"ELL mg_solve with cycle_type=f: {im['cycles']} cycles, "
             f"residual {rm:.3e}")
    fmg.update(cycle_type="f", plain_v_cycles=ell_cycles,
               mg_solve={"cycles": im["cycles"], "residual_float64_host": rm,
                         "wall_s": wall})
    return pcg, fmg


def phase_solve_sparse(dev, solvers):
    import openmg_tpu_torch as mg

    def rhs(n, seed):
        bnp = np.random.default_rng(seed).standard_normal(n)
        bnp /= np.linalg.norm(bnp)
        return torch.from_numpy(bnp.astype(np.float32)).to(dev)

    def merged(info):
        hi, lo = info["x_df"]
        if not bool(torch.isfinite(hi).all() and torch.isfinite(lo).all()):
            fail("sparse solve: solution is not finite")
        return hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)

    def timed_solve(solver, b):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        x, info = solver.solve(b)
        torch.cuda.synchronize()
        return info, resident, torch.cuda.max_memory_allocated()

    # 1. BSR at full width: the main path of K7
    solver, A = solvers["bsr"], solvers["bsr_matrix"]
    h = solver.hierarchy
    b = b_bsr = rhs(h.n, 1)
    zero_counts()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    stencil_counts, sp_counts = counts(), sparse_counts()
    cycles = info["cycles"]
    visited = h.num_levels - 1
    if not info["converged"] or cycles == 0:
        fail(f"BSR solve: {info['residual_norms']}")
    if any(stencil_counts.values()) or sp_counts != {
            "K6": 0, "K7": 5 * visited * cycles}:
        fail(f"BSR solve: launches {sp_counts} {stencil_counts} for {cycles} "
             f"cycles, {visited} visited levels")
    if not (x.device == dev and x.dtype == torch.float32
            and tuple(x.shape) == (h.n,)):
        fail("BSR solve did not deliver a float32 tensor on the card")
    x64 = merged(info)
    b64 = b.cpu().numpy().astype(np.float64)
    rn_bsr = float(np.linalg.norm(b64 - A @ x64))
    if not rn_bsr < 2e-10:
        fail(f"BSR solve: float64 residual {rn_bsr:.3e}")
    info2, resident, peak = timed_solve(solver, b)
    info_bsr = info2
    bsr = {
        "matrix": f"coupled_diffusion({BSR_SHAPE}, 4)", "rows": h.n,
        "levels": [list(s) for s in h.stats], "cycles": cycles,
        "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn_bsr, "launches": sp_counts,
        "launches_per_cycle": sp_counts["K7"] / cycles,
        "setup_s": solvers["bsr_setup_s"],
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms": info2["solve_time_s"] * 1e3,
        "ms_per_cycle": info2["solve_time_s"] * 1e3 / max(info2["cycles"], 1),
        "resident_before_MB": resident / 2 ** 20, "peak_memory_MB": peak / 2 ** 20,
    }

    # 2. ELL at full width through mg_solve: the main path of K6
    n = int(np.prod(ELL_SHAPE))
    b = b_ell = rhs(n, 2)
    A = mg.poisson(ELL_SHAPE)
    zero_counts()
    t0 = time.perf_counter()
    x, info = mg.mg_solve(A, b, dict(ELL_PARAMS), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stencil_counts, sp_counts = counts(), sparse_counts()
    cycles = info["cycles"]
    colors = info["num_colors"]
    per_cycle = sum(1 + 4 * c for c in colors[:-1])
    if not info["converged"] or cycles == 0 or info["format"] != "ell":
        fail(f"ELL mg_solve: {info['residual_norms']}")
    if any(stencil_counts.values()) or sp_counts != {
            "K6": per_cycle * cycles, "K7": 0}:
        fail(f"ELL mg_solve: launches {sp_counts} {stencil_counts} for "
             f"{cycles} cycles")
    b64 = b.cpu().numpy().astype(np.float64)
    x64 = merged(info)
    if not np.array_equal(x, info["x_df"][0].cpu().numpy()):
        fail("ELL mg_solve: x is not the hi part of the pair")
    rn_ell = residual_norm_host(b64.reshape(ELL_SHAPE), x64.reshape(ELL_SHAPE))
    if not rn_ell < 2e-10:
        fail(f"ELL mg_solve: float64 residual {rn_ell:.3e}")
    info_a, _, _ = timed_solve(solvers["ell"], b)
    info_b, resident, peak = timed_solve(solvers["ell"], b)
    if info_b["cycles"] != cycles:
        fail("ELL: mg_solve and the set-up solver took different cycle counts")
    ell = {
        "matrix": f"poisson({ELL_SHAPE})", "rows": n,
        "levels": [list(s) for s in info["level_stats"]], "num_colors": colors,
        "cycles": cycles, "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn_ell, "launches": sp_counts,
        "launches_per_cycle": sp_counts["K6"] / cycles,
        "setup_s": solvers["ell_setup_s"], "mg_solve_wall_s": wall,
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms": info_b["solve_time_s"] * 1e3,
        "solve_ms_again": info_a["solve_time_s"] * 1e3,
        "ms_per_cycle": info_b["solve_time_s"] * 1e3 / max(cycles, 1),
        "resident_before_MB": resident / 2 ** 20, "peak_memory_MB": peak / 2 ** 20,
    }

    # 3. the card against the CPU (plain versions)
    el = dict(smoother="jacobi", transfer="linear", gridlevels=4,
              max_dense_coarse=4096, cycles=100, threshold=1e-8)
    cases = [
        ("ELL 128^2 rbgs", mg.poisson((128, 128)), (128, 128), 1,
         dict(format="ell", smoother="rbgs", transfer="linear",
              max_dense_coarse=256, threshold=1e-10), None),
        ("BSR coupled diffusion 16^3 B=4 rbgs",
         mg.coupled_diffusion((16, 16, 16), 4), (16, 16, 16), 4,
         dict(format="bsr", blocksize=4, smoother="rbgs", transfer="linear",
              max_dense_coarse=4096, threshold=1e-10), None),
        ("elasticity 128^2 B=2, BSR", mg.elasticity((128, 128)), (128, 128), 2,
         dict(format="bsr", blocksize=2, **el), 22),
        ("elasticity 128^2 B=2, ELL", mg.elasticity((128, 128)), (128, 128), 2,
         dict(format="ell", blocksize=1, **el), 22),
    ]
    versus = []
    for name, A, shape, dofs, kw, want in cases:
        cfg = mg.SolverConfig(**kw)
        bnp = np.random.default_rng(0).standard_normal(A.shape[0])
        bnp /= np.linalg.norm(bnp)
        zero_counts()
        xg, ig = mg.setup_sparse(A, shape, cfg, dofs=dofs, device=dev).solve(bnp)
        torch.cuda.synchronize()
        launched = sparse_counts()
        xc, ic = mg.setup_sparse(A, shape, cfg, dofs=dofs, device="cpu").solve(bnp)
        lam = (sum(4.0 * np.sin(np.pi / (2 * (m + 1))) ** 2 for m in shape)
               if dofs == 1 else lambda_min(A))
        dx = float(np.linalg.norm(xg - xc))
        row = {"case": name, "cycles_card": ig["cycles"],
               "cycles_cpu": ic["cycles"], "dx_norm": dx,
               "dx_bound": 2e-10 / lam, "lambda_min": lam,
               "launches": launched, "final_norm_card": ig["final_norm"]}
        versus.append(row)
        if not (ig["converged"] and ic["converged"]
                and ig["cycles"] == ic["cycles"] and dx <= 2e-10 / lam):
            fail(f"card against CPU, {name}: {row}")
        if want is not None and ig["cycles"] != want:
            fail(f"{name}: {ig['cycles']} cycles, the reference took {want}")

    # 4. the ELL engine against the stencil engine on the card
    cfg = mg.SolverConfig(smoother="jacobi", transfer="aggregate",
                          threshold=1e-10, cycles=12)
    bs = mg.rhs_random(ELL_SHAPE, seed=8)
    _, i_sten = mg.setup(ELL_SHAPE, cfg, device=dev).solve(bs)
    _, i_gen = mg.setup_sparse(mg.poisson(ELL_SHAPE), ELL_SHAPE, cfg,
                               device=dev).solve(bs.ravel())
    a = np.asarray(i_sten["residual_norms"][:10])
    g = np.asarray(i_gen["residual_norms"][:10])
    if len(a) != 10 or len(g) != 10 or not np.allclose(g, a, rtol=1e-4, atol=0):
        fail(f"ELL against stencil engine: {g} vs {a}")

    # 5. where the two full-width solves spend their time: each part alone,
    # then the profiler, which slows every launch after it attaches
    for row, sv, bb, ii in ((bsr, solvers["bsr"], b_bsr, info_bsr),
                            (ell, solvers["ell"], b_ell, info_b)):
        row["phases_ms"] = sparse_phases(sv, bb, ii)
    for row, sv, bb in ((bsr, solvers["bsr"], b_bsr), (ell, solvers["ell"], b_ell)):
        row["profile"] = profile_solve(sv, bb)
        row["device_idle_share"] = max(
            0.0, 1.0 - row["profile"]["device_busy_ms"] / row["solve_ms"])

    # 6. PCG(2) on the BSR hierarchy and FMG on the ELL one
    pcg, fmg = sparse_pcg_fmg(dev, solvers, b_bsr, b_ell, bsr["cycles"],
                              ell["cycles"])

    emit("solve_sparse", {
        "bsr": bsr, "ell": ell, "card_vs_cpu": versus,
        "ell_vs_stencil": {"shape": list(ELL_SHAPE), "sparse": g.tolist(),
                           "stencil": a.tolist(),
                           "max_rel": float(np.max(np.abs(g - a) / a))},
        "pcg": pcg, "fmg": fmg,
    })
    return bsr["launches"]["K7"], ell["launches"]["K6"]


def phase_solve_many_sparse(dev, solvers):
    """``AlgebraicSolver.solve_many`` at K=4 (seeds 1-4, each normalised),
    from a float32 card batch, with the checks of ``solve_many``: on the
    1024² ELL hierarchy (one K6b launch a product of the stack: 1 + 4 ·
    colours a visited level a step) and on the 64³ coupled-diffusion BSR
    hierarchy (B = 4; one K7b launch a product: five a visited level a
    step; its transfers, explicit ELL matrices of four unknowns a node, go
    member by member as tensor code).  No scalar K6 or K7 launch."""
    K = 4
    out = {}
    for fmt in ("ell", "bsr"):
        solver = solvers[fmt]
        n = solver.n
        bnps = []
        for seed in range(1, K + 1):
            bnp = np.random.default_rng(seed).standard_normal(n)
            bnps.append(bnp / np.linalg.norm(bnp))
        bt = torch.from_numpy(np.stack(bnps).astype(np.float32)).to(dev)
        b32 = [bnp.astype(np.float32).astype(np.float64) for bnp in bnps]
        scalar, scalar_ms = scalar_solves(solver, bt)
        levels = solver.hierarchy.levels
        if fmt == "ell":
            per_step = sum(1 + 4 * lv.num_colors for lv in levels[:-1])
            want = lambda cs, p=per_step: {"K6b": p * max(cs)}  # noqa: E731
            resid = lambda k, x64: residual_norm_host(  # noqa: E731
                b32[k].reshape(ELL_SHAPE), x64.reshape(ELL_SHAPE))
            matrix = f"poisson({ELL_SHAPE})"
        else:
            A = solvers["bsr_matrix"]
            per_step = 5 * (len(levels) - 1)
            want = lambda cs, p=per_step: {"K7b": p * max(cs)}  # noqa: E731
            resid = lambda k, x64, A=A: float(  # noqa: E731
                np.linalg.norm(b32[k] - A @ x64))
            matrix = f"coupled_diffusion({BSR_SHAPE}, 4)"
        row = many_check(f"sparse solve_many {fmt}", solver, bt, resid, want, scalar)
        row.update(matrix=matrix, format=fmt, scalar_solve_ms=scalar_ms,
                   launches_per_step=per_step,
                   batch_over_scalar=row["ms_per_rhs"] / scalar_ms)
        out[fmt] = row
        del bt, scalar
        torch.cuda.empty_cache()
    emit("solve_many_sparse", out)
    return out

# ---------------------------------------------------------------------------
# W and FMG cycles, MG-preconditioned CG, batched solves
# ---------------------------------------------------------------------------

MAIN_CFG = dict(DIFFUSION_CFG, cycles=60)  # the main path's settings
INNER_KW = {"pcg": dict(krylov="pcg", krylov_iters=2),
            "w": dict(cycle_type="w"), "f": dict(cycle_type="f")}
# the JAX package's record of the 256³ MG-PCG(2) solve (BENCH_r05.json:
# "solve (mg-pcg2): outer=3 final=4.23e-11"): a cycle count, not a time
PCG_RECORD_OUTER = 3


def level_visits(num_levels, cycle_type):
    """Level visits of one cycle: V visits each level above the coarsest
    once; W visits level l 2^l times (the level just above the coarsest
    visits the coarsest once); FMG runs a V-cycle from every level."""
    n = num_levels - 1
    if cycle_type == "w":
        return sum(2 ** lv for lv in range(n))
    if cycle_type == "f":
        return n * (n + 1) // 2
    return n


def inner_cycles(cfg):
    """Cycles an outer step runs: ``krylov_iters`` with PCG, else one."""
    return cfg.krylov_iters if cfg.krylov == "pcg" else 1


def all_counts():
    return {**counts(), **sparse_counts(), **batch_counts()}


def card_solve(what, solver, b, residual_host, want_launches, max_cycles=9):
    """One solve of ``solver`` from the card tensor ``b`` with the launch
    counts read around it, checked: converged below 1e-10 in at most
    ``max_cycles`` outer steps, launches equal to ``want_launches(cycles)``
    (every kernel named, the others 0), the float64 residual of the merged
    pair below 2e-10 (``residual_host``); then a warm solve, bit-equal, for
    the times and the peak memory."""
    zero_counts()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    launched = all_counts()
    cycles = info["cycles"]
    if not info["converged"] or not info["final_norm"] < 1e-10 or cycles > max_cycles:
        fail(f"{what}: {cycles} cycles, {info['residual_norms']}")
    want = {k: 0 for k in launched}
    want.update(want_launches(cycles))
    if cycles == 0 or launched != want:
        fail(f"{what}: launches {launched} for {cycles} cycles, expected {want}")
    hi, lo = info["x_df"]
    if not bool(torch.isfinite(hi).all() and torch.isfinite(lo).all()):
        fail(f"{what}: solution is not finite")
    x64 = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
    rn64 = residual_host(x64)
    del hi, lo, x64
    if not rn64 < 2e-10:
        fail(f"{what}: float64 residual of the merged pair is {rn64:.3e}")
    torch.cuda.reset_peak_memory_stats()
    x2, info2 = solver.solve(b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(x2, x):
        fail(f"{what}: two solves of the same system differ")
    return {
        "cycles": cycles, "final_norm": info["final_norm"],
        "residual_norms": info["residual_norms"],
        "residual_float64_host": rn64,
        "launches": {k: v for k, v in launched.items() if v},
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms": info2["solve_time_s"] * 1e3,
        "peak_memory_MB": peak / 2 ** 20,
    }


def main_rhs(shape, dev, seed=1):
    """``rhs_random(shape, seed)`` normalised, as a float32 card tensor."""
    import openmg_tpu_torch as mg

    bnp = mg.rhs_random(shape, seed=seed)
    bnp /= np.linalg.norm(bnp.ravel())
    return torch.from_numpy(bnp.astype(np.float32)).to(dev)


def stencil_launches(cfg, h, kernel):
    """``want_launches`` of a constant/cornered hierarchy's solve: two
    launches of the level-visit kernel (K1 in 3D, K5 in 2D) a level visit,
    one K2 launch an outer step."""
    visits = level_visits(h.num_levels, cfg.cycle_type) * inner_cycles(cfg)
    return lambda c: {kernel: 2 * visits * c, "K2": c}


def inner_solves_stencil(dev, which, base, inners):
    """The 256³ or 4096² Poisson solve with each of ``inners`` ("pcg",
    "w", "f") on one hierarchy (``base``: the main path's solver)."""
    import openmg_tpu_torch as mg

    h = base.hierarchy
    shape = h.grid_shape
    b = main_rhs(shape, dev)
    b64 = b.cpu().numpy().astype(np.float64)
    kernel = "K1" if len(shape) == 3 else "K5"
    out = {}
    for ct in inners:
        cfg = mg.SolverConfig(**MAIN_CFG, **INNER_KW[ct])
        row = card_solve(
            f"{which} {ct}", mg.Solver(h, cfg), b,
            lambda x64: residual_norm_host(b64, x64),
            stencil_launches(cfg, h, kernel))
        row.update(shape=list(shape), levels=[list(s[0]) for s in h.stats],
                   cycle_type=cfg.cycle_type, krylov=cfg.krylov,
                   krylov_iters=cfg.krylov_iters)
        out[ct] = row
    return out


def card_vs_cpu_cycles(dev):
    """The (32, 32, 64) solve of ``solve.small_solve`` with a W cycle, FMG
    and PCG(2), on the card against the CPU (plain versions): equal cycle
    counts, ‖Δx‖₂ ≤ 2e-10/λ_min."""
    import openmg_tpu_torch as mg

    small = (32, 32, 64)
    bs = mg.rhs_random(small, seed=0)
    bs /= np.linalg.norm(bs.ravel())
    lam_min = sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in small)
    rows = []
    for ct, kw in INNER_KW.items():
        scfg = mg.SolverConfig(**{**DIFFUSION_CFG, "gridlevels": 3,
                                  "max_dense_coarse": 1024, **kw})
        xg, ig = mg.solve(small, bs, scfg, device=dev)
        xc, ic = mg.solve(small, bs, scfg, device="cpu")
        dx = float(np.linalg.norm((xg - xc).ravel()))
        row = {"inner": ct, "shape": list(small), "cycles_card": ig["cycles"],
               "cycles_cpu": ic["cycles"], "dx_norm": dx,
               "dx_bound": 2e-10 / lam_min}
        rows.append(row)
        if not (ig["converged"] and ic["converged"]
                and ig["cycles"] == ic["cycles"] and dx <= 2e-10 / lam_min):
            fail(f"card against CPU, {ct}: {row}")
    return rows


def count_d2h(fn):
    """Device-to-host copies ``fn()`` makes, by ``torch.profiler`` (events
    named ``Memcpy DtoH``), and its result."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages() if "Memcpy DtoH" in ev.key)
    return n, out


def many_check(what, solver, bt, residual_host, want_launches, scalar,
               members=None, threshold=1e-10, residual_bound=2e-10):
    """``solver.solve_many`` of the card batch ``bt``: every member
    converged below ``threshold``, its cycles and its iterate (the pair, in
    the double-float mode) bit-equal to its scalar solve (``scalar``: per
    member (x hi, x lo or None, cycles)), the launches
    ``want_launches(cycles of each member)``, one host read before the first step
    and one after every step (the loop's own count, in this run and in a
    second one under the profiler, which sees no more device-to-host copies
    than that), the float64 residual of the members
    ``members`` (all when None) below ``residual_bound`` (None: reported,
    not held); then three warm batches for the time (median) and the peak
    memory."""
    K = bt.shape[0]
    zero_counts()
    xs, info = solver.solve_many(bt)
    torch.cuda.synchronize()
    launched = all_counts()
    cycles = info["cycles"]
    if not all(info["converged"]) or max(info["final_norm"]) >= threshold:
        fail(f"{what}: {info['final_norm']} after {cycles} cycles")
    if cycles != [c for _, _, c in scalar]:
        fail(f"{what}: cycles {cycles}, the scalar solves "
             f"{[c for _, _, c in scalar]}")
    hi, lo = info.get("x_df", (xs, None))
    if xs is not hi or tuple(hi.shape[:1]) != (K,):
        fail(f"{what}: the batch is not delivered as the stacked hi parts")
    for k, (x_k, lo_k, _) in enumerate(scalar):
        if not (torch.equal(hi[k], x_k)
                and (lo is None or torch.equal(lo[k], lo_k))):
            fail(f"{what}: member {k} is not bit-equal to its scalar solve")
    want = {k: 0 for k in launched}
    want.update(want_launches(cycles))
    if launched != want:
        fail(f"{what}: launches {launched}, expected {want}")
    steps = max(cycles)
    if info["host_reads"] != steps + 1:
        fail(f"{what}: {info['host_reads']} host reads for {steps} steps")
    rn64 = []
    for k in range(K) if members is None else members:
        x64 = hi[k].cpu().numpy().astype(np.float64)
        if lo is not None:
            x64 += lo[k].cpu().numpy().astype(np.float64)
        rn64.append(residual_host(k, x64))
        del x64
    if residual_bound is not None and not max(rn64) < residual_bound:
        fail(f"{what}: float64 residuals {rn64}")
    del xs, hi, lo
    info.pop("x_df", None)
    # the profiler loses a record in some calls (it has counted 7 of the 8
    # reads of the 256³ batch in one run and all 8 in others), never adds
    # one: the loop's own count is held exact, the profiler's as a ceiling
    copies, again = count_d2h(lambda: solver.solve_many(bt)[1])
    again.pop("x_df", None)
    if again["host_reads"] != steps + 1 or copies > again["host_reads"]:
        fail(f"{what}: {copies} device-to-host copies, the loop made "
             f"{again['host_reads']} reads for {steps} steps")
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(3):
        _, info2 = solver.solve_many(bt)
        info2.pop("x_df", None)
        warm.append(info2["solve_time_s"] * 1e3)
    peak = torch.cuda.max_memory_allocated()
    return {
        "K": K, "cycles": cycles, "final_norm": info["final_norm"],
        "residual_float64_host": rn64,
        "residual_float64_host_members": list(range(K)) if members is None
        else list(members),
        "bit_equal_to_scalar": True,
        "launches": {k: v for k, v in launched.items() if v},
        "host_reads": info["host_reads"], "steps": steps,
        "host_reads_per_step": info["host_reads"] / (steps + 1),
        "d2h_copies_profiled": copies,
        "first_solve_ms": info["solve_time_s"] * 1e3,
        "solve_ms_warm_runs": warm,
        "solve_ms": statistics.median(warm),
        "ms_per_rhs": statistics.median(warm) / K,
        "peak_memory_MB": peak / 2 ** 20,
    }


def scalar_solves(solver, bt):
    """Each member of the card batch solved alone: (x hi, x lo or None,
    cycles), and the median of three warm solves of member 0 (ms)."""
    out = []
    for k in range(bt.shape[0]):
        x, info = solver.solve(bt[k].clone())
        out.append((x, info.get("x_df", (None, None))[1], info["cycles"]))
    b0 = bt[0].clone()
    warm = [solver.solve(b0)[1]["solve_time_s"] * 1e3 for _ in range(3)]
    return out, statistics.median(warm)


def phase_solve_many(dev, poisson):
    """``Solver.solve_many`` at 256³, at BENCH_r05's (64, 64, 128) and at
    4096², K=8 (seeds 1-8, each normalised), from a float32 card batch and
    from numpy: the batch runs as one stack, one launch of K1b (K5b in 2D)
    a level visit and one of K2b an outer step for all members, and no
    scalar K1, K2 or K5 launch."""
    import openmg_tpu_torch as mg

    K = 8
    out = {}
    mid = mg.setup((64, 64, 128), mg.SolverConfig(**MAIN_CFG), device=dev)
    plane = mg.setup(BIG2, mg.SolverConfig(**MAIN_CFG), device=dev)
    for tag, solver in (("256^3", poisson), ("64x64x128", mid),
                        ("4096^2", plane)):
        h = solver.hierarchy
        shape = h.grid_shape
        visit = "K1b" if len(shape) == 3 else "K5b"
        bnps = []
        for seed in range(1, K + 1):
            bnp = mg.rhs_random(shape, seed=seed)
            bnps.append(bnp / np.linalg.norm(bnp.ravel()))
        bt = torch.from_numpy(np.stack(bnps).astype(np.float32)).to(dev)
        b32 = [bnp.astype(np.float32).astype(np.float64) for bnp in bnps]
        scalar, scalar_ms = scalar_solves(solver, bt)
        visits = 2 * (h.num_levels - 1)
        row = many_check(
            f"solve_many {tag}", solver, bt,
            lambda k, x64: residual_norm_host(b32[k], x64),
            lambda cs: {visit: visits * max(cs), "K2b": max(cs)}, scalar)
        del scalar
        row.update(shape=list(shape), levels=[list(st[0]) for st in h.stats],
                   scalar_solve_ms=scalar_ms,
                   batch_over_scalar=row["ms_per_rhs"] / scalar_ms)
        # numpy input: stacked float64; member 0 bit-equal to its scalar
        # numpy solve, the first and last members' float64 residuals
        t0 = time.perf_counter()
        xs_np, info_np = solver.solve_many(bnps)
        wall = time.perf_counter() - t0
        x0_np, i0 = solver.solve(bnps[0])
        if not (isinstance(xs_np, np.ndarray) and xs_np.dtype == np.float64
                and xs_np.shape == (K,) + tuple(shape)
                and all(info_np["converged"])
                and np.array_equal(xs_np[0], x0_np)
                and info_np["cycles"][0] == i0["cycles"]):
            fail(f"solve_many {tag} from numpy: {info_np['cycles']}, "
                 f"{info_np['final_norm']}")
        rn_np = [residual_norm_host(bnps[k], xs_np[k]) for k in (0, K - 1)]
        if not max(rn_np) < 2e-10:
            fail(f"solve_many {tag} from numpy: float64 residuals {rn_np}")
        row["numpy_input"] = {
            "cycles": info_np["cycles"], "final_norm": info_np["final_norm"],
            "residual_float64_host_first_last": rn_np,
            "member0_bit_equal_to_scalar": True, "wall_ms": wall * 1e3,
            "host_reads": info_np["host_reads"],
        }
        del xs_np, bt
        out[tag] = row
        torch.cuda.empty_cache()
    del mid, plane
    torch.cuda.empty_cache()
    return out


FACED_MANY = (64, 64, 128)  # solve_many_stack's faced grid (BENCH_r05's)


def faced_hierarchy(dev, shape, cfg):
    """The hierarchy of ``setup(shape, cfg)`` with its cornered levels as
    ``FacedStencilOperator``s (``faced_ops`` of the ``faced=False`` form, as
    the ``faced`` phase builds them), and how many there are."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.core.hierarchy import Level

    h = mg.setup(shape, cfg, device=dev).hierarchy
    ops = faced_ops(mg.setup(shape, cfg, faced=False, device=dev).hierarchy)
    levels = list(h.levels)
    for i, op in ops.items():
        levels[i] = Level(A=op, inv_diag=1.0 / op.values[0])
    return dataclasses.replace(h, levels=tuple(levels)), len(ops)


def phase_solve_many_stack(dev, vary, unfaced, h_big):
    """``Solver.solve_many`` at K = 8 (seeds 1-8, each normalised, a float32
    card batch) where the batch needs K3b and K4b, each held as
    ``solve_many`` holds its batches (``many_check``): the 256³ diffusion
    solve (K4b legs, the general double-float step on the stack), the 256³
    Poisson solve on the ``faced=False`` hierarchy (K1b and K2b on the fine
    level, K4b legs below), the 256³ Poisson solve with Chebyshev smoothing
    (a K3b residual launch a Chebyshev iteration and a visit's residual)
    and with a float32 outer residual (K1b visits, one K3b launch a
    residual), and the (64, 64, 128) solve on faced levels (K3b passes and
    tensor face rows).  The hierarchies are the earlier phases'; no scalar
    K1-K7 launch anywhere.  The float64 host residual of the 256³ members
    is computed for the first and the last member."""
    import openmg_tpu_torch as mg

    K = BATCH_K
    main = mg.SolverConfig(**MAIN_CFG)
    cheb = mg.SolverConfig(**CHEB_CFG)
    f32 = mg.SolverConfig(**{**MAIN_CFG, "residual_dtype": "float32",
                             "threshold": F32_THRESHOLD})
    h_faced, n_faced = faced_hierarchy(dev, FACED_MANY, main)
    vsolver, offsets, coeffs = vary[0], vary[1], vary[2]
    per = 2 if main.smoother == "rbgs" else 1
    k3_faced = per * (main.pre_iterations + main.post_iterations) + 1

    def rhs(shape):
        bnps = []
        for seed in range(1, K + 1):
            bnp = mg.rhs_random(shape, seed=seed)
            bnps.append(bnp / np.linalg.norm(bnp.ravel()))
        return bnps

    def poisson_resid(b32):
        return lambda k, x64: residual_norm_host(b32[k], x64)

    cases = [
        ("256^3 diffusion", vsolver,
         lambda h: lambda cs: {"K4b": legs_per_cycle(main, h) * max(cs)},
         "stencil", {}),
        ("256^3 Poisson faced=False", unfaced[0],
         lambda h: lambda cs: {"K1b": 2 * max(cs), "K2b": max(cs),
                               "K4b": legs_per_cycle(main, h) * max(cs)},
         "poisson", {}),
        ("256^3 Poisson chebyshev", mg.Solver(h_big, cheb),
         lambda h: lambda cs: {"K3b": cheb_launches(cheb, h, "K3b")(max(cs))["K3b"],
                               "K2b": max(cs)},
         "poisson", {}),
        ("256^3 Poisson float32 residual", mg.Solver(h_big, f32),
         lambda h: lambda cs: {"K1b": 2 * (h.num_levels - 1) * max(cs),
                               "K3b": max(cs) + 1},
         "poisson", dict(threshold=F32_THRESHOLD, residual_bound=None)),
        ("x".join(map(str, FACED_MANY)) + " faced", mg.Solver(h_faced, main),
         lambda h: lambda cs: {"K1b": 2 * max(cs), "K2b": max(cs),
                               "K3b": k3_faced * n_faced * max(cs)},
         "poisson", {}),
    ]
    out = {}
    for tag, solver, want, kind, kw in cases:
        h = solver.hierarchy
        shape = h.grid_shape
        bnps = rhs(shape)
        bt = torch.from_numpy(np.stack(bnps).astype(np.float32)).to(dev)
        b32 = [bnp.astype(np.float32).astype(np.float64) for bnp in bnps]
        del bnps
        if kind == "stencil":
            resid = lambda k, x64: residual_norm_host_stencil(  # noqa: E731
                offsets, coeffs, b32[k], x64)
        else:
            resid = poisson_resid(b32)
        scalar, scalar_ms = scalar_solves(solver, bt)
        big = shape == BIG
        row = many_check(f"solve_many {tag}", solver, bt, resid, want(h), scalar,
                         members=(0, K - 1) if big else None, **kw)
        del scalar, bt, b32
        row.update(shape=list(shape), levels=[type(L.A).__name__ for L in h.levels],
                   residual_mode=solver.residual_mode if isinstance(
                       solver.residual_mode, str) else str(solver.residual_mode),
                   smoother=solver.config.smoother, scalar_solve_ms=scalar_ms,
                   batch_over_scalar=row["ms_per_rhs"] / scalar_ms)
        out[tag] = row
        torch.cuda.empty_cache()
    del h_faced
    emit("solve_many_stack", out)
    return out


def phase_solve_cycles_pcg(dev):
    """The 256³ and 4096² Poisson solves with PCG(2), W and FMG on the main
    path's hierarchies, ``solve_many``, and the card against the CPU."""
    import openmg_tpu_torch as mg

    poisson = mg.setup(BIG, mg.SolverConfig(**MAIN_CFG), device=dev)
    p3 = inner_solves_stencil(dev, "256^3", poisson, ("pcg", "w", "f"))
    many = phase_solve_many(dev, poisson)
    del poisson
    torch.cuda.empty_cache()
    poisson2d = mg.setup(BIG2, mg.SolverConfig(**MAIN_CFG), device=dev)
    p2 = inner_solves_stencil(dev, "4096^2", poisson2d, ("pcg", "f"))
    del poisson2d
    torch.cuda.empty_cache()
    versus = card_vs_cpu_cycles(dev)
    pcg = p3["pcg"]
    pcg["reference_outer_steps"] = PCG_RECORD_OUTER
    pcg["matches_reference_outer_steps"] = pcg["cycles"] == PCG_RECORD_OUTER
    emit("solve_cycles", {"w_256^3": p3["w"], "f_256^3": p3["f"],
                          "f_4096^2": p2["f"], "card_vs_cpu": versus})
    emit("solve_many", many)
    return {"poisson_256^3": pcg, "poisson_4096^2": p2["pcg"]}, many


def phase_solve_pcg(dev, pcg, vary):
    """Adds the 256³ diffusion solve with PCG(2) (K4 legs, the general
    double-float residual) to the Poisson PCG solves and prints the
    ``solve_pcg`` line."""
    import openmg_tpu_torch as mg

    solver, offsets, coeffs = vary[:3]
    h = solver.hierarchy
    b = main_rhs(h.grid_shape, dev)
    b64 = b.cpu().numpy().astype(np.float64)
    cfg = mg.SolverConfig(**MAIN_CFG, **INNER_KW["pcg"])
    legs = legs_per_cycle(cfg, h) * inner_cycles(cfg)
    row = card_solve(
        "diffusion pcg", mg.Solver(h, cfg), b,
        lambda x64: residual_norm_host_stencil(offsets, coeffs, b64, x64),
        lambda c: {"K4": legs * c})
    row.update(shape=list(h.grid_shape), krylov=cfg.krylov,
               krylov_iters=cfg.krylov_iters)
    emit("solve_pcg", {**pcg, "diffusion_256^3": row})
    return row



# ---------------------------------------------------------------------------
# Chebyshev smoothing, the faced operator, 1D grids, setup on the device
# ---------------------------------------------------------------------------

CHEB_CFG = dict(MAIN_CFG, smoother="chebyshev")  # cycles=60
# the cycles the JAX package's Chebyshev solve takes at 16³
# (tests/test_cycles.py) are 14 against red/black's 7: room for the 256³ one
CHEB_MAX_CYCLES = 60


def cheb_launches(cfg, h, kernel):
    """``want_launches`` of a Chebyshev solve on ``h``: a level visit is
    ``pre + post + 1`` launches of the per-pass residual kernel (K3 on a
    constant or cornered level, K4 on a varying one: ``pre`` Chebyshev
    iterations, the level residual, ``post`` iterations); one K2 launch an
    outer step where the fine operator is constant with dyadic taps."""
    per_visit = cfg.pre_iterations + cfg.post_iterations + 1
    visits = level_visits(h.num_levels, cfg.cycle_type)
    k2 = h.fine_hi.is_constant
    return lambda c: {kernel: per_visit * visits * c, **({"K2": c} if k2 else {})}


def d2h_per_step(what, solver, b, cycles):
    """One host read a step: the loop's own count (``info["host_reads"]``)
    of a warm solve is ``cycles + 1`` (a read before every step and one
    after the last), and the profiler sees no more device-to-host copies
    than that (it has counted 12 of the 13 reads of the 256³ Chebyshev
    solve in some calls and all 13 in others; never more)."""
    copies, (_, info) = count_d2h(lambda: solver.solve(b))
    reads = info["host_reads"]
    if info["cycles"] != cycles or reads != cycles + 1 or copies > reads:
        fail(f"{what}: {reads} host reads and {copies} device-to-host copies "
             f"for {info['cycles']} steps")
    return {"host_reads": reads, "d2h_copies_profiled": copies}


def tensor_share(prof, kernel_names):
    """The share of the device's busy time not spent in ``kernel_names``
    (substrings of the kernels' names): the tensor code around them."""
    busy = prof["device_busy_ms"]
    ours = sum(v["ms"] for k, v in prof["kernels"].items()
               if any(n in k for n in kernel_names))
    return (busy - ours) / busy if busy else None


def phase_solve_cheb(dev, vary):
    """Chebyshev on the card: the 256³ Poisson solve on the ``faced=True``
    hierarchy (K3 with its region table on the cornered levels, K2), the
    256³ diffusion solve (K4's per-pass residual on every varying level),
    the 4096² solve (K3 on the 2D lift), (32, 32, 64) on the card against
    the CPU, and one host read a step."""
    import openmg_tpu_torch as mg

    cfg = mg.SolverConfig(**CHEB_CFG)
    out = {}
    t0 = time.perf_counter()
    solver = mg.setup(BIG, cfg, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    h = solver.hierarchy
    kinds = [type(L.A).__name__ for L in h.levels]
    b = main_rhs(BIG, dev)
    b64 = b.cpu().numpy().astype(np.float64)
    row = card_solve("chebyshev 256^3", solver, b,
                     lambda x64: residual_norm_host(b64, x64),
                     cheb_launches(cfg, h, "K3"), max_cycles=CHEB_MAX_CYCLES)
    row["host_reads"] = d2h_per_step("chebyshev 256^3", solver, b,
                                          row["cycles"])
    prof = profile_solve(solver, b, top=12)
    row.update(shape=list(BIG), level_kinds=kinds, setup_s=t_setup,
               profile=prof,
               tensor_code_share=tensor_share(prof, ("pass_kernel", "df_")))
    out["poisson_256^3"] = row
    del solver, h

    vs = mg.Solver(vary[0].hierarchy, mg.SolverConfig(**CHEB_CFG))
    offsets, coeffs = vary[1], vary[2]
    bv = main_rhs(BIG, dev, seed=2)
    bv64 = bv.cpu().numpy().astype(np.float64)
    row = card_solve("chebyshev diffusion 256^3", vs, bv,
                     lambda x64: residual_norm_host_stencil(offsets, coeffs, bv64, x64),
                     cheb_launches(vs.config, vs.hierarchy, "K4"),
                     max_cycles=CHEB_MAX_CYCLES)
    prof = profile_solve(vs, bv, top=12)
    row.update(shape=list(BIG), profile=prof,
               tensor_code_share=tensor_share(prof, ("pass_kernel",)))
    out["diffusion_256^3"] = row
    del vs

    s2 = mg.setup(BIG2, cfg, device=dev)
    b2 = main_rhs(BIG2, dev)
    b264 = b2.cpu().numpy().astype(np.float64)
    row = card_solve("chebyshev 4096^2", s2, b2,
                     lambda x64: residual_norm_host(b264, x64),
                     cheb_launches(cfg, s2.hierarchy, "K3"),
                     max_cycles=CHEB_MAX_CYCLES)
    row.update(shape=list(BIG2), levels=[list(st[0]) for st in s2.hierarchy.stats])
    out["poisson_4096^2"] = row
    del s2

    small = (32, 32, 64)
    bs = mg.rhs_random(small, seed=0)
    bs /= np.linalg.norm(bs.ravel())
    lam_min = sum(4.0 * np.sin(np.pi / (2 * (n + 1))) ** 2 for n in small)
    scfg = mg.SolverConfig(**{**CHEB_CFG, "gridlevels": 3, "max_dense_coarse": 1024})
    xg, ig = mg.solve(small, bs, scfg, device=dev)
    xc, ic = mg.solve(small, bs, scfg, device="cpu")
    dx = float(np.linalg.norm((xg - xc).ravel()))
    out["card_vs_cpu"] = {"shape": list(small), "cycles_card": ig["cycles"],
                          "cycles_cpu": ic["cycles"], "dx_norm": dx,
                          "dx_bound": 2e-10 / lam_min}
    if not (ig["converged"] and ic["converged"] and ig["cycles"] == ic["cycles"]
            and dx <= 2e-10 / lam_min):
        fail(f"chebyshev card against CPU: {out['card_vs_cpu']}")
    emit("solve_cheb", out)
    return {k: v["launches"] for k, v in out.items() if "launches" in v}


FACED_TOL_ABS = 1e-5  # tests/test_faced.py's tolerance
FACED_TOL_REL = 2e-6


def faced_ops(h):
    """The ``FacedStencilOperator`` of each varying level of ``h`` (its
    grids read to the host, ``detect_faced`` as tests/test_faced.py builds
    it), by level index."""
    from openmg_tpu_torch.core.hierarchy import detect_faced
    from openmg_tpu_torch.ops.stencil import FacedStencilOperator

    out = {}
    for i, L in enumerate(h.levels[:-1]):
        if L.A.is_constant:
            continue
        C = L.A.coeffs.cpu().numpy()
        fd = detect_faced(L.A.offsets, C)
        if fd is None:
            fail(f"level {i} {L.grid_shape} is not faced")
        vals, axes, planes = fd
        dev = L.A.coeffs.device
        out[i] = FacedStencilOperator(
            values=torch.from_numpy(vals.astype(np.float32)).to(dev),
            face_coeffs=tuple(torch.from_numpy(p.astype(np.float32)).to(dev)
                              for p in planes),
            offsets=L.A.offsets, shape=L.A.grid_shape, face_axes=axes,
        )
        del C
    return out


def on_cpu(op):
    return dataclasses.replace(op, values=op.values.cpu(),
                               face_coeffs=tuple(f.cpu() for f in op.face_coeffs))


def phase_faced(dev, unfaced, faced_cycles):
    """The faced operator on the card: the 128³, 64³ and 32³ levels of the
    256³ Poisson hierarchy as ``FacedStencilOperator``s (from the unfaced
    hierarchy's grids); ``apply``, ``residual`` and one Jacobi and one
    red/black ``smooth`` held against the varying operator on the card (K4
    passes) and against the faced operator's plain version on the CPU;
    then the 256³ solve on the hierarchy with those faced levels."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.core.hierarchy import Level
    from openmg_tpu_torch.ops import smoothers, stencil

    solver = unfaced[0]
    h = solver.hierarchy
    ops = faced_ops(h)
    rows = []
    for i, op in ops.items():
        L = h.levels[i]
        shape = L.grid_shape
        b, x = randn(shape, 40 + i, dev), randn(shape, 50 + i, dev)
        cop = on_cpu(op)
        calls = {
            "apply": (lambda A, bb, xx, inv: stencil.apply(A, xx), 0),
            "residual": (lambda A, bb, xx, inv: stencil.residual(A, bb, xx), 1),
            "jacobi": (lambda A, bb, xx, inv: smoothers.smooth(
                "jacobi", A, inv, bb, xx, 1, OMEGA), 1),
            "rbgs": (lambda A, bb, xx, inv: smoothers.smooth(
                "rbgs", A, inv, bb, xx, 1, OMEGA), 2),
        }
        for name, (fn, k3) in calls.items():
            zero_counts()
            got = fn(op, b, x, None)
            torch.cuda.synchronize()
            launched = counts()
            vary = fn(L.A, b, x, L.inv_diag)
            plain = fn(cop, b.cpu(), x.cpu(), None)
            torch.cuda.synchronize()
            if launched != {"K1": 0, "K2": 0, "K3": k3, "K4": 0, "K5": 0}:
                fail(f"faced {shape} {name}: launches {launched}")
            errs = {}
            for ref_name, ref in (("varying_K4", vary.cpu()), ("cpu_plain", plain)):
                err = float((got.cpu() - ref).abs().max())
                tol = max(FACED_TOL_ABS, FACED_TOL_REL * float(ref.abs().max()))
                if not err <= tol:
                    fail(f"faced {shape} {name} against {ref_name}: err "
                         f"{err:.3e} > {tol:.3e}")
                errs[ref_name] = {"max_abs_err": err, "tolerance": tol}
            ms = time_ms(lambda: fn(op, b, x, None), 5)
            ms_vary = time_ms(lambda: fn(L.A, b, x, L.inv_diag), 5)
            rows.append({"level": list(shape), "call": name,
                         "k3_launches": k3, "ms": ms, "ms_varying": ms_vary,
                         **errs})
        del b, x, cop

    levels = list(h.levels)
    for i, op in ops.items():
        levels[i] = Level(A=op, inv_diag=1.0 / op.values[0])
    hf = dataclasses.replace(h, levels=tuple(levels))
    cfg = solver.config
    fs = mg.Solver(hf, cfg)
    b = main_rhs(BIG, dev)
    b64 = b.cpu().numpy().astype(np.float64)
    per = 2 if cfg.smoother == "rbgs" else 1
    k3_visit = per * (cfg.pre_iterations + cfg.post_iterations) + 1
    n_faced = len(ops)
    row = card_solve(
        "faced 256^3", fs, b, lambda x64: residual_norm_host(b64, x64),
        lambda c: {"K1": 2 * c, "K2": c, "K3": n_faced * k3_visit * c})
    if row["cycles"] != faced_cycles:
        fail(f"faced solve: {row['cycles']} cycles, the cornered solve took "
             f"{faced_cycles}")
    row.update(level_kinds=[type(L.A).__name__ for L in hf.levels],
               cycles_cornered=faced_cycles,
               face_planes_MB=sum(f.numel() * 4 for op in ops.values()
                                  for f in op.face_coeffs) / 2 ** 20)
    emit("faced", {"calls": rows, "solve": row})
    return row["launches"]


BASELINE1 = dict(gridlevels=2, smoother="jacobi", pre_iterations=2,
                 post_iterations=2, cycles=400, max_dense_coarse=64)


def k3_call(mode, values, offsets, b, x, corner):
    """One K3 pass (its plain version for CPU tensors) in ``mode``."""
    from openmg_tpu_torch.ops import kernels

    if mode == "residual":
        return kernels.residual_const_3d(values, offsets, b, x, corner=corner)
    if mode == "jacobi":
        return kernels.jacobi_const_3d(values, offsets, b, x, 1, OMEGA,
                                       corner=corner)
    return kernels.rbgs_half_sweep_const_3d(values, offsets, b, x, 0,
                                            corner=corner)


def lift_rows_1d(dev, h):
    """K3 on the 1D lift ``(1, 1, n)`` (every visited level of ``h``:
    constant, then cornered 3-point) and K2 on it, against their plain
    versions; K3 timed with its bound."""
    from openmg_tpu_torch.ops import kernels
    from openmg_tpu_torch.ops.doublefloat import pow2_terms

    rows = []
    for L in h.levels[:-1]:
        A = L.A
        corner = (A.regions, A.table) if hasattr(A, "regions") else None
        corner_c = None if corner is None else (corner[0], corner[1].cpu())
        n = L.grid_shape[0]
        b, x = randn((n,), 60, dev), randn((n,), 61, dev)
        for mode in ("residual", "jacobi", "rbgs"):
            before = kernels.LAUNCHES_K3
            got = k3_call(mode, A.values, A.offsets, b, x, corner)
            torch.cuda.synchronize()
            moved = kernels.LAUNCHES_K3 - before
            ref = k3_call(mode, A.values.cpu(), A.offsets, b.cpu(), x.cpu(), corner_c)
            err = float((got.cpu() - ref).abs().max())
            tol = SWEEP_TOL * float((b.cpu() if mode == "residual" else ref).abs().max())
            if moved != 1 or not err <= tol:
                fail(f"K3 on the 1D lift, {n} {mode}: launches {moved}, err "
                     f"{err:.3e} > {tol:.3e}")
            nbytes, flops, _ = sweep_bound(n, A.offsets, False, mode)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            rows.append({
                "kernel": "K3", "level": [1, 1, n], "mode": mode,
                "cornered": corner is not None, "max_abs_err": err,
                "tolerance": tol,
                "ms": time_ms(lambda: k3_call(mode, A.values, A.offsets, b, x,
                                              corner), 20),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    # K2 on the lift, bit for bit
    A0 = h.levels[0].A
    n = A0.grid_shape[0]
    terms = tuple(pow2_terms(float(v)) for v in A0.values.cpu().numpy())
    args = [randn((n,), 70 + j, dev, 1e-3 if j == 1 else 1.0) for j in range(5)]
    before = kernels.LAUNCHES
    got = kernels.df_update_residual_const_3d(A0.offsets, terms, *args, emit_norm=True)
    torch.cuda.synchronize()
    moved = kernels.LAUNCHES - before
    ref = kernels.df_update_residual_const_3d(A0.offsets, terms,
                                              *[a.cpu() for a in args], emit_norm=True)
    equal = all(torch.equal(g.cpu(), r) for g, r in zip(got[:3], ref[:3]))
    tot, want = float(got[3].sum()), float(torch.sum(ref[2].double() ** 2))
    if moved != 1 or not equal or abs(tot - want) > 1e-6 * want:
        fail(f"K2 on the 1D lift: launches {moved}, bit-equal {equal}, "
             f"norm {tot} against {want}")
    rows.append({"kernel": "K2", "level": [1, 1, n], "bit_equal": equal,
                 "ms": time_ms(lambda: kernels.df_update_residual_const_3d(
                     A0.offsets, terms, *args, emit_norm=True), 20)})
    return rows


def phase_solve_1d(dev):
    """1D grids on the card (the ``(1, 1, n)`` lift: K3 passes, K2, the
    tensor transfers): BASELINE config 1 and N = 256 at full depth (red/black
    and Jacobi) against the CPU; K3 and K2 on the lift against their plain
    versions; and a float64 cycle refused."""
    import openmg_tpu_torch as mg

    out = {"runs": []}
    cases = [
        ("baseline config 1", (64,), BASELINE1),
        ("256 rbgs full depth", (256,), dict(MAIN_CFG, max_dense_coarse=8)),
        ("256 jacobi full depth", (256,), dict(MAIN_CFG, smoother="jacobi",
                                                max_dense_coarse=8)),
    ]
    for what, shape, kw in cases:
        cfg = mg.SolverConfig(**kw)
        sg = mg.setup(shape, cfg, device=dev)
        sc = mg.setup(shape, cfg, device="cpu")
        h = sg.hierarchy
        if kw is BASELINE1:
            # the right-hand side of tests/test_solver.py, not normalised:
            # the JAX package takes 36 cycles on it
            b = torch.from_numpy(mg.rhs_random(shape, seed=0).astype(np.float32)).to(dev)
        else:
            b = main_rhs(shape, dev, seed=1)
        bnp = b.cpu().numpy().astype(np.float64)
        per = 2 if cfg.smoother == "rbgs" else 1
        k3_visit = per * (cfg.pre_iterations + cfg.post_iterations) + 1
        visits = h.num_levels - 1
        row = card_solve(what, sg, b, lambda x64: residual_norm_host(bnp, x64),
                         lambda c: {"K3": k3_visit * visits * c, "K2": c},
                         max_cycles=cfg.cycles)
        xc, ic = sc.solve(bnp)
        if ic["cycles"] != row["cycles"] or not ic["converged"]:
            fail(f"1D {what}: card {row['cycles']} cycles, CPU {ic['cycles']}")
        row.update(case=what, shape=list(shape), cycles_cpu=ic["cycles"],
                   levels=[list(st[0]) for st in h.stats],
                   level_kinds=[type(L.A).__name__ for L in h.levels])
        out["runs"].append(row)
    out["lift_kernels"] = lift_rows_1d(
        dev, mg.setup((256,), mg.SolverConfig(**dict(MAIN_CFG, max_dense_coarse=8)),
                      device=dev).hierarchy)
    try:
        mg.setup((64,), mg.SolverConfig(**dict(BASELINE1, dtype="float64")),
                 device=dev)
    except NotImplementedError:
        out["refused_on_card"] = ["float64 cycle"]
    else:
        fail("a float64 cycle was set up on the card")
    emit("solve_1d", out)
    return out["runs"][0]["launches"]


SETUP_TOL = 1e-5  # |device − host| ≤ SETUP_TOL · max|host| per level


def compare_levels(what, hd, hh):
    """Per level: offsets equal, coefficients and inverse diagonals within
    ``SETUP_TOL`` · max|host| (float32 chains summed in the same order)."""
    if hd.num_levels != hh.num_levels:
        fail(f"{what}: {hd.num_levels} levels, the host chain {hh.num_levels}")
    rows = []
    for i, (Ld, Lh) in enumerate(zip(hd.levels, hh.levels)):
        if Ld.A.offsets != Lh.A.offsets or Ld.A.is_constant != Lh.A.is_constant:
            fail(f"{what} level {i}: offsets or kind differ")
        if Ld.A.is_constant:
            a, c = Ld.A.values.cpu(), Lh.A.values.cpu()
        else:
            a, c = Ld.A.coeffs.cpu(), Lh.A.coeffs.cpu()
        err = float((a.double() - c.double()).abs().max())
        tol = SETUP_TOL * float(c.abs().max())
        ierr = float((Ld.inv_diag.cpu().double().reshape(-1)
                      - Lh.inv_diag.cpu().double().reshape(-1)).abs().max())
        itol = SETUP_TOL * float(Lh.inv_diag.abs().max())
        if not (err <= tol and ierr <= itol):
            fail(f"{what} level {i}: coefficients {err:.3e} (tol {tol:.3e}), "
                 f"inv_diag {ierr:.3e} (tol {itol:.3e})")
        rows.append({"level": list(Ld.grid_shape), "taps": len(Ld.A.offsets),
                     "constant": Ld.A.is_constant, "max_abs_err": err,
                     "tolerance": tol, "inv_diag_max_abs_err": ierr})
    if tuple(hd.stats) != tuple(hh.stats):
        fail(f"{what}: stats {hd.stats} against {hh.stats}")
    return rows


def float64_rounding(what, hd, h64):
    """Per level of the float32 device chain ``hd``: its coefficients and
    inverse diagonal against the float64 host chain ``h64``'s cast to
    float32, within ``SETUP_TOL`` · max|ref| (float32 rounding of the same
    sums; about 6e-7 relative at 64³)."""
    rows = []
    for i, (Ld, L64) in enumerate(zip(hd.levels, h64.levels)):
        if Ld.A.offsets != L64.A.offsets:
            fail(f"{what} level {i}: offsets differ from the float64 chain's")
        pair = []
        for a, c in ((Ld.A.values if Ld.A.is_constant else Ld.A.coeffs,
                      L64.A.values if L64.A.is_constant else L64.A.coeffs),
                     (Ld.inv_diag, L64.inv_diag)):
            ref = c.cpu().to(torch.float32).double().reshape(-1)
            got = a.cpu().double().reshape(-1)
            pair.append(float((got - ref).abs().max()) / float(ref.abs().max()))
        if not max(pair) <= SETUP_TOL:
            fail(f"{what} level {i}: {pair} from the float64 chain (relative)")
        rows.append({"level": list(Ld.grid_shape), "max_rel_err": pair[0],
                     "inv_diag_max_rel_err": pair[1]})
    return rows


def phase_setup_device(dev, vary):
    """``build_hierarchy_device`` on the card for the 256³ diffusion
    coefficients and 256³ Poisson: its setup time beside the host Galerkin
    chain's (``build_hierarchy``) in this run, its levels against the host
    chain's, its peak memory, and a solve on each with the host-built
    hierarchy's cycle count."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.core.hierarchy import build_hierarchy_device
    from openmg_tpu_torch.models.poisson import poisson_offsets
    from openmg_tpu_torch.ops.transfer import TRANSFERS

    from openmg_tpu_torch.core import hierarchy as hmod

    cfg = mg.SolverConfig(**MAIN_CFG)
    tr = TRANSFERS[cfg.transfer]
    common = dict(transfer=tr, max_dense_coarse=cfg.max_dense_coarse)
    out = {}
    # the seconds of the coarsest level's dense inverse (host LAPACK, in
    # both chains), read out of the setup times
    inv_s = []
    real_inverse = hmod._coarse_inverse

    def timed_inverse(*a, **k):
        t = time.perf_counter()
        got = real_inverse(*a, **k)
        inv_s.append(time.perf_counter() - t)
        return got

    hmod._coarse_inverse = timed_inverse

    def build(**kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        hd = build_hierarchy_device(device=dev, **common, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return hd, dt, (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    # diffusion: the stencil pair's float64 grids, moved to the card
    host_solver, offsets, coeffs, _, t_host = vary
    hd, t_dev, peak = build(offsets=offsets, coeffs=coeffs)
    inv_dev = inv_s[-1]
    levels = compare_levels("diffusion", hd, host_solver.hierarchy)
    # and against the host chain in float64, on the host
    h64 = mg.build_hierarchy(offsets, coeffs, setup_dtype="float64",
                             dtype=torch.float64, residual_dtype=torch.float64,
                             device="cpu", **common)
    rounding = float64_rounding("diffusion", hd, h64)
    del h64
    c32 = coeffs.astype(np.float32).astype(np.float64)  # the operator it solves
    b = main_rhs(BIG, dev, seed=2)
    b64 = b.cpu().numpy().astype(np.float64)
    host_cycles = host_solver.solve(b)[1]["cycles"]
    solver = mg.Solver(hd, cfg)
    row = card_solve("device-built diffusion", solver, b,
                     lambda x64: residual_norm_host_stencil(offsets, c32, b64, x64),
                     lambda c: {"K4": legs_per_cycle(cfg, hd) * c}, max_cycles=60)
    if row["cycles"] != host_cycles:
        fail(f"device-built diffusion: {row['cycles']} cycles, host-built "
             f"{host_cycles}")
    out["diffusion_256^3"] = {"setup_s_device": t_dev, "setup_s_host_chain": t_host,
                              "coarse_inverse_s_device_build": inv_dev,
                              "against_float64_host_chain": rounding,
                              "peak_memory_MB_build": peak, "levels": levels,
                              "solve": row, "cycles_host_built": host_cycles}
    del hd, solver

    # Poisson: the constant fine stencil, materialized on the card for the
    # first RAP step only; the host chain from the stencil pair
    values = [6.0] + [-1.0] * 6
    hd, t_dev, peak = build(offsets=poisson_offsets(3), fine_values=values,
                            shape=BIG)
    inv_dev = inv_s[-1]
    t0 = time.perf_counter()
    p_offsets, p_coeffs = mg.poisson_stencil(BIG, dtype=np.float32)
    hh = mg.build_hierarchy(p_offsets, p_coeffs, residual_dtype="doublefloat",
                            device=dev, **common)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    inv_host = inv_s[-1]
    del p_coeffs
    levels = compare_levels("poisson", hd, hh)
    b = main_rhs(BIG, dev)
    b64 = b.cpu().numpy().astype(np.float64)
    host_cycles = mg.Solver(hh, cfg).solve(b)[1]["cycles"]
    del hh
    solver = mg.Solver(hd, cfg)
    row = card_solve("device-built poisson", solver, b,
                     lambda x64: residual_norm_host(b64, x64),
                     lambda c: {"K1": 2 * c, "K2": c,
                                "K4": legs_per_cycle(cfg, hd) * c})
    if row["cycles"] != host_cycles:
        fail(f"device-built poisson: {row['cycles']} cycles, host-built "
             f"{host_cycles}")
    hmod._coarse_inverse = real_inverse
    out["poisson_256^3"] = {"setup_s_device": t_dev, "setup_s_host_chain": t_host,
                            "coarse_inverse_s_device_build": inv_dev,
                            "coarse_inverse_s_host_chain": inv_host,
                            "peak_memory_MB_build": peak, "levels": levels,
                            "solve": row, "cycles_host_built": host_cycles,
                            "fine_grids_MB_transient": 7 * 4 * int(np.prod(BIG)) / 2 ** 20}
    emit("setup_device", out)
    return {k: v["solve"]["launches"] for k, v in out.items()}

# ---------------------------------------------------------------------------
# the halo forms of K1–K4 and the distributed solve
# ---------------------------------------------------------------------------

HALO_SLABS = 4  # halo_kernels: 256³ (and 128³) cut into this many z-slabs
# solve_dist: ranks on the one card, each its own process
DIST_RANKS = (2, 4)
DIST_TIMEOUT_S = 360
DIFFUSION_DIST = (128, 128, 128)


def halo_counts():
    from openmg_tpu_torch.ops import fused, kernels

    return {"K1_halo": fused.LAUNCHES_HALO, "K2_halo": kernels.LAUNCHES_K2_HALO,
            "K3_halo": kernels.LAUNCHES_K3_HALO, "K4_halo": kernels.LAUNCHES_K4_HALO}


def zero_halo_counts():
    from openmg_tpu_torch.ops import fused, kernels

    fused.LAUNCHES_HALO = kernels.LAUNCHES_K2_HALO = 0
    kernels.LAUNCHES_K3_HALO = kernels.LAUNCHES_K4_HALO = 0


def cut(t, i, P, lo, hi):
    """Slab i of P along axis 0 and its neighbours' planes: the ``lo`` last
    of slab i − 1 and the ``hi`` first of slab i + 1 (zeros at the domain
    edges), as a rank would receive them."""
    n = t.shape[0] // P

    def z(k):
        return torch.zeros((k,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)

    lower = t[i * n - lo:i * n] if i > 0 else z(lo)
    upper = t[(i + 1) * n:(i + 1) * n + hi] if i < P - 1 else z(hi)
    return t[i * n:(i + 1) * n].contiguous(), lower.contiguous(), upper.contiguous()


def halo_case(what, run, run_plain, run_whole, tol_scale, exact, bound, copy_bw,
              P=HALO_SLABS, reps=20):
    """One halo form on every slab: held against its plain version on the
    same slab (bit for bit where ``exact``, else within K1_TOL · scale)
    and bit for bit against the rows of the whole-grid kernel.  ``run(i)``
    only launches the wrapper on slab i's operands, which the caller cut
    once beforehand.  Device ms of a launch on an inner slab (both halos
    live; the calls rotate over the inner slabs) beside the whole-grid
    launch's device ms / P and the slab's bound; ``ms_host_paced`` is one
    call's time by events around it, which counts the host's cost of the
    call where the launch is shorter."""
    whole = run_whole()
    whole = whole if isinstance(whole, tuple) else (whole,)
    torch.cuda.synchronize()
    parts, worst_plain, worst_whole = [], 0.0, 0.0
    for i in range(P):
        got = run(i)
        got = got if isinstance(got, tuple) else (got,)
        ref = run_plain(i)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        for j, (g, r) in enumerate(zip(got, ref)):
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                fail(f"halo {what} slab {i}: bad output {j}")
            err = float((g - r).abs().max())
            if (exact and not torch.equal(g, r)) or err > K1_TOL * tol_scale[j]:
                fail(f"halo {what} slab {i} output {j}: err {err:.3e} against "
                     f"the plain version (tolerance {K1_TOL * tol_scale[j]:.3e})")
            worst_plain = max(worst_plain, err)
        parts.append(got)
    for j, w in enumerate(whole):
        cat = torch.cat([p[j] for p in parts])
        err = float((cat - w).abs().max())
        if not torch.equal(cat, w):
            fail(f"halo {what} output {j}: err {err:.3e}, not bit-equal to the "
                 f"whole-grid kernel's rows")
        worst_whole = max(worst_whole, err)
    nbytes, flops = bound
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    inner = [functools.partial(run, i) for i in range(1, P - 1)]
    return {
        "case": what, "max_abs_err": worst_plain,
        "max_abs_err_vs_whole_grid_kernel": worst_whole,
        "bit_equal_to_plain": exact, "bit_equal_to_whole_grid_kernel": True,
        "ms": device_ms(inner, reps),
        "whole_ms_over_P": device_ms([run_whole], reps) / P,
        "ms_host_paced": time_ms(lambda: run(1), reps),
        "whole_ms_over_P_host_paced": time_ms(run_whole, reps) / P,
        "plain_ms": time_ms(lambda: run_plain(1), 3, warm=1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_ms_copy_bw": nbytes / copy_bw * 1e3, "library_ms": None,
    }


def phase_halo_kernels(dev, copy_bw, h_vary):
    """K1–K4's halo forms on 256³ (and the cornered 128³ level) cut into
    ``HALO_SLABS`` z-slabs, each slab's planes from its neighbours by
    slicing."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import fused, kernels

    P = HALO_SLABS
    h = mg.setup(BIG, mg.SolverConfig(**MAIN_CFG), device=dev).hierarchy
    tr = h.transfer
    rb4 = fused.stages_for("rbgs", 2, OMEGA)
    rows = {"K1": [], "K2": [], "K3": [], "K4": []}
    zero_halo_counts()
    for tag, L in (("256^3 constant", h.levels[0]), ("128^3 cornered", h.levels[1])):
        op = L.A
        shape = L.grid_shape
        nz = shape[0]
        n = int(np.prod(shape)) // P
        plane = shape[1] * shape[2]
        cshape = tuple(s // 2 for s in shape)
        nc = int(np.prod(cshape)) // P
        corner = fused._corner_info(op)
        V, O, K = op.values, op.offsets, len(op.offsets)
        b = randn(shape, 11, dev)
        x = randn(shape, 12, dev)
        ec = randn(cshape, 13, dev)
        bmax = float(b.abs().max())
        # K3: one pass of each mode
        for mode, kmode, color in SWEEP_MODES:
            whole = lambda: kernels._half_sweep(  # noqa: E731
                V, b, x, offsets=O, mode=kmode, omega=OMEGA, color=color, corner=corner)

            slabs = [(cut(b, i, P, 0, 0)[0],) + cut(x, i, P, 1, 1) for i in range(P)]

            def one(i, plain=False, kmode=kmode, color=color, slabs=slabs):
                bs, xs, lo, hi = slabs[i]
                if plain:
                    return kernels.half_sweep_plain(
                        V, O, bs, xs, kmode, OMEGA, color,
                        fused.gate_corner(corner, int(i > 0)), halos=(lo, hi))
                return kernels.halo_half_sweep_const_3d(
                    V, O, bs, xs, kmode, OMEGA, color, lo, hi, corner=corner,
                    open_lo=int(i > 0))

            nb, fl, _ = sweep_bound(n, O, False, kmode)
            ref_scale = float(whole().abs().max()) if kmode != "residual" else bmax
            rows["K3"].append({"level": tag, "mode": mode, "shape": [nz // P] + list(shape[1:]),
                               **halo_case(f"K3 {mode} {tag}", one,
                                           lambda i, one=one: one(i, True), whole,
                                           (ref_scale,), False, (nb + 8 * plane, fl), copy_bw)})
        # K1: the down-leg, the up-leg with ec, the residual with restriction
        k1 = {
            "down: zero start, 4 rb stages, restrict": dict(
                stages=rb4, emit_residual=True, restrict_transfer=tr, has_x=False),
            "up: x + P ec, 4 rb stages": dict(
                stages=rb4, ec=True, prolong_transfer=tr, has_x=True),
            "residual + restrict, no x out": dict(
                stages=(), emit_residual=True, restrict_transfer=tr, emit_x=False,
                has_x=True),
        }
        for mode, kw in k1.items():
            kw = dict(kw)
            has_x, use_ec = kw.pop("has_x"), kw.pop("ec", False)
            D = fused.halo_depth(len(kw["stages"]), kw.get("emit_residual", False),
                                 "restrict_transfer" in kw, use_ec)

            def whole(kw=kw, has_x=has_x, use_ec=use_ec):
                return fused.fused_stages_const_3d(
                    V, O, b, x if has_x else None, corner=corner,
                    ec=ec if use_ec else None, **kw)

            def slab(i, D=D, has_x=has_x, use_ec=use_ec):
                bs, blo, bhi = cut(b, i, P, D, D)
                xs, xlo, xhi = cut(x, i, P, D, D)
                es, elo, ehi = cut(ec, i, P, D // 2, D // 2 + 1)
                return bs, xs, es, ((int(i > 0), int(i < P - 1)), (blo, bhi),
                                    (xlo, xhi) if has_x else None,
                                    (elo, ehi) if use_ec else None)

            slabs = [slab(i) for i in range(P)]

            def one(i, plain=False, kw=kw, has_x=has_x, use_ec=use_ec, slabs=slabs):
                bs, xs, es, halos = slabs[i]
                if plain:
                    return fused.fused_stages_const_3d_plain(
                        V, O, bs, xs if has_x else None,
                        corner=fused.gate_corner(corner, int(i > 0)),
                        ec=es if use_ec else None, halos=halos, **kw)
                return fused.fused_stages_const_3d(
                    V, O, bs, xs if has_x else None, corner=corner,
                    ec=es if use_ec else None, halos=halos, **kw)

            outs = whole()
            outs = outs if isinstance(outs, tuple) else (outs,)
            scales = []
            names = (("r",) if not kw.get("emit_x", True)
                     else ("x", "r") if kw.get("emit_residual") else ("x",))
            for nm, o in zip(names, outs):
                scales.append(bmax if nm == "r" else float(o.abs().max()))
            nb, fl = k1_bound(mode, n, nc, K)
            halo_bytes = 4 * plane * 2 * D * (2 if has_x else 1)
            rows["K1"].append({"level": tag, "mode": mode, "depth": D,
                               "shape": [nz // P] + list(shape[1:]),
                               **halo_case(f"K1 {mode} {tag}", one,
                                           lambda i, one=one: one(i, True), whole,
                                           tuple(scales), False,
                                           (nb + halo_bytes, fl), copy_bw)})
        del b, x, ec
    # K2 on 256³
    shape = BIG
    n = int(np.prod(shape)) // P
    plane = shape[1] * shape[2]
    L0 = h.levels[0]
    terms = mg.core.solver.exact_residual_terms(h)
    xh = randn(shape, 21, dev)
    xl = randn(shape, 22, dev, 1e-8)
    e = randn(shape, 23, dev, 1e-3)
    bh = randn(shape, 24, dev)
    bl = randn(shape, 25, dev, 1e-8)

    def k2_slab(i):
        sl = [cut(t, i, P, 1, 1) for t in (xh, xl, e, bh, bl)]
        return [s[0] for s in sl], tuple((s[1], s[2]) for s in sl[:3])

    k2_slabs = [k2_slab(i) for i in range(P)]

    def k2_one(i, plain=False):
        args, halos = k2_slabs[i]
        if plain:
            return kernels.df_update_residual_const_3d_plain(
                L0.A.offsets, terms, *args, True, halos)
        return kernels.df_update_residual_const_3d(
            L0.A.offsets, terms, *args, emit_norm=True, halos=halos)

    def k2_whole():
        out = kernels.df_update_residual_const_3d(
            L0.A.offsets, terms, xh, xl, e, bh, bl, emit_norm=True)
        return out

    nb, fl = k2_bound(n, terms, True)
    row = {"level": "256^3 constant", "mode": "emit_norm", "shape": [shape[0] // P, *shape[1:]]}
    # the kernel's partials are its own (one a block): compare x', x_lo', r
    # bit for bit and the norms' sums
    row.update(halo_case(
        "K2 256^3", lambda i: k2_one(i)[:3], lambda i: k2_one(i, True)[:3],
        lambda: k2_whole()[:3], (1.0, 1.0, 1.0), True, (nb + 24 * plane, fl), copy_bw))
    pn = sum(float(k2_one(i)[3].double().sum()) for i in range(P))
    pw = float(k2_whole()[3].double().sum())
    if abs(pn - pw) > 1e-6 * pw:
        fail(f"halo K2: ‖r‖² over the slabs {pn} against the whole grid's {pw}")
    row["norm_sq_slabs"], row["norm_sq_whole"] = pn, pw
    rows["K2"].append(row)
    del xh, xl, e, bh, bl, k2_slabs
    # K4: one pass on the 256³ diffusion grids
    Lv = h_vary.levels[0]
    op = Lv.A
    shape = Lv.grid_shape
    n = int(np.prod(shape)) // P
    b = randn(shape, 31, dev)
    x = randn(shape, 32, dev)
    m = shape[0] // P
    # a rank's own coefficient grids: cut (copied) once, as _slab_op does
    k4_slabs = [(op.coeffs[:, i * m:(i + 1) * m].contiguous(), cut(b, i, P, 0, 0)[0])
                + cut(x, i, P, 1, 1) for i in range(P)]
    for mode, kmode, color in (("rb colour 0", "rbgs", 0), ("residual", "residual", 0)):
        def whole(kmode=kmode, color=color):
            return kernels._half_sweep_vary(
                op.coeffs, b, x, offsets=op.offsets, mode=kmode, omega=OMEGA, color=color)

        def one(i, plain=False, kmode=kmode, color=color):
            cs, bs, xs, lo, hi = k4_slabs[i]
            if plain:
                return kernels.half_sweep_vary_plain(
                    cs, op.offsets, bs, xs, kmode, OMEGA, color, halos=(lo, hi))
            return kernels.halo_half_sweep_vary_3d(
                cs, op.offsets, bs, xs, kmode, OMEGA, color, lo, hi)

        nb, fl, _ = sweep_bound(n, op.offsets, True, kmode)
        scale = float(b.abs().max()) if kmode == "residual" else float(whole().abs().max())
        rows["K4"].append({"level": "256^3 diffusion", "mode": mode,
                           "shape": [shape[0] // P, *shape[1:]],
                           **halo_case(f"K4 {mode}", one, lambda i, one=one: one(i, True),
                                       whole, (scale,), False,
                                       (nb + 8 * shape[1] * shape[2], fl), copy_bw)})
    del k4_slabs, b, x
    launched = halo_counts()
    if not all(launched.values()):
        fail(f"halo_kernels: launches {launched}")
    # the scalar K3h's yardstick: A x of its slab and planes by F.conv3d
    k3h = next(r for r in rows["K3"] if r["level"] == "256^3 constant"
               and r["mode"] == "residual")
    k3h.update(library_conv3d(h.levels[0].A, 1, dev))
    rows.update(halo_batch_rows(dev, copy_bw, h, h_vary))
    emit("halo_kernels", {"slabs": P, "rows": rows, "launches": launched,
                          "launches_batch": halo_batch_counts(),
                          "batch_K": BATCH_K, "wall_s_batch": rows.pop("wall_s")})
    del h
    torch.cuda.empty_cache()
    return rows


def halo_batch_counts():
    """Launches of the halo forms on a batch (K1hb-K4hb, K6hb)."""
    from openmg_tpu_torch.ops import ell, fused, kernels

    return {"K1hb": fused.LAUNCHES_HALO_BATCH, "K2hb": kernels.LAUNCHES_K2_HALO_BATCH,
            "K3hb": kernels.LAUNCHES_K3_HALO_BATCH,
            "K4hb": kernels.LAUNCHES_K4_HALO_BATCH, "K6hb": ell.LAUNCHES_K6H_BATCH}


def zero_halo_batch_counts():
    from openmg_tpu_torch.ops import ell, fused, kernels

    fused.LAUNCHES_HALO_BATCH = kernels.LAUNCHES_K2_HALO_BATCH = 0
    kernels.LAUNCHES_K3_HALO_BATCH = kernels.LAUNCHES_K4_HALO_BATCH = 0
    ell.LAUNCHES_K6H_BATCH = 0


def library_conv3d(op, K, dev, reps=10):
    """The yardstick beside a halo residual pass of the constant operator
    ``op`` on an inner slab of ``BIG`` / ``HALO_SLABS`` (K members: batch K):
    ``A x`` of the slab by one ``F.conv3d`` over the slab extended by its
    two planes (made beforehand), zero padding on y and x, TF32 off.  Its
    device ms, its result held against the tensor ``apply``; the port never
    calls it."""
    from openmg_tpu_torch.ops.stencil import apply

    shape = (BIG[0] // HALO_SLABS,) + BIG[1:]
    xe = randn_card((K, shape[0] + 2) + shape[1:], 60 + K, dev)
    ms, got = conv_batch_ms(op, xe, reps, padding=(0, 1, 1))
    want = torch.stack([apply(op, xe[m])[1:-1] for m in range(K)])
    err = float((got - want).abs().max())
    if err > 2e-6 * float(xe.abs().max()) * 12:
        fail(f"conv3d halo yardstick (K {K}) disagrees: {err:.3e}")
    return {"library_ms": ms, "library": f"F.conv3d 3x3x3 with batch {K} over the slab "
            "and its two planes, zero padding on y and x, TF32 off (computes A x only)"}


def halo_batch_rows(dev, copy_bw, h, h_vary):
    """K1hb, K2hb, K3hb and K4hb at K = ``BATCH_K`` on an inner slab of 256³
    / ``HALO_SLABS`` (K1hb and K3hb on the cornered 128³ one too), every
    member with its own received planes (drawn on the card): each held
    against its batched plain version at the scalar halo form's tolerance
    (K2hb's outputs bit for bit) and member by member against K launches of
    the scalar halo form bit for bit; device ms beside the K scalar
    launches' and the batched bound (K × the scalar slab's bytes, the
    coefficient grids once for K4hb).  K3hb's residual has ``F.conv3d``
    with batch K over the slabs and their planes as a yardstick."""
    from openmg_tpu_torch.core.solver import exact_residual_terms
    from openmg_tpu_torch.ops import fused, kernels

    t0 = time.perf_counter()
    K, P = BATCH_K, HALO_SLABS
    tr = h.transfer
    rb4 = fused.stages_for("rbgs", 2, OMEGA)
    rows = {"K1hb": [], "K2hb": [], "K3hb": [], "K4hb": []}
    zero_halo_batch_counts()
    zero_halo_counts()
    for tag, L in (("256^3 constant", h.levels[0]), ("128^3 cornered", h.levels[1])):
        op = L.A
        slab = (L.grid_shape[0] // P,) + tuple(L.grid_shape[1:])
        plane = slab[1:]
        n = int(np.prod(slab))
        cslab = tuple(v // 2 for v in slab)
        nc = int(np.prod(cslab))
        corner = fused._corner_info(op)
        gated = fused.gate_corner(corner, 1)
        V, O = op.values, op.offsets
        b, x = randn_card((K,) + slab, 70, dev), randn_card((K,) + slab, 71, dev)
        lo, hi = randn_card((K, 1) + plane, 72, dev), randn_card((K, 1) + plane, 73, dev)
        for mode, kmode, color in SWEEP_MODES:
            args = (O, b, x, kmode, OMEGA, color, lo, hi)
            nb, fl, _ = sweep_bound(n, O, False, kmode)
            row = batch_case(
                f"K3hb {mode} {tag}", ("r",) if kmode == "residual" else ("x",),
                functools.partial(kernels.halo_half_sweep_batch, V, *args,
                                  corner=corner, open_lo=1),
                lambda m, kmode=kmode, color=color: kernels.halo_half_sweep_const_3d(
                    V, O, b[m], x[m], kmode, OMEGA, color, lo[m], hi[m], corner=corner,
                    open_lo=1),
                functools.partial(kernels.halo_half_sweep_batch_plain, V, *args, gated),
                b, K, (nb + 8 * int(np.prod(plane)), fl), copy_bw)
            if tag.startswith("256") and kmode == "residual":
                row.update(library_conv3d(op, K, dev))
            row.update(level=tag, mode=mode, shape=[K, *slab])
            rows["K3hb"].append(row)
        k1 = {
            "down: zero start, 4 rb stages, restrict": (
                dict(stages=rb4, emit_residual=True, restrict_transfer=tr), False, False),
            "up: x + P ec, 4 rb stages": (dict(stages=rb4, prolong_transfer=tr), True, True),
            "residual + restrict, no x out": (
                dict(stages=(), emit_residual=True, restrict_transfer=tr, emit_x=False),
                True, False),
        }
        ec = randn_card((K,) + cslab, 74, dev)
        for mode, (kw, has_x, use_ec) in k1.items():
            D = fused.halo_depth(len(kw["stages"]), kw.get("emit_residual", False),
                                 "restrict_transfer" in kw, use_ec)
            halos = ((1, 1), (randn_card((K, D) + plane, 75, dev),
                              randn_card((K, D) + plane, 76, dev)),
                     (randn_card((K, D) + plane, 77, dev),
                      randn_card((K, D) + plane, 78, dev)) if has_x else None,
                     (randn_card((K, D // 2) + cslab[1:], 79, dev),
                      randn_card((K, D // 2 + 1) + cslab[1:], 80, dev)) if use_ec else None)
            bkw = dict(kw, ec=ec) if use_ec else kw
            xx = x if has_x else None

            def run_m(m, kw=kw, halos=halos, xx=xx, use_ec=use_ec):
                mh = (halos[0],) + tuple(None if p is None else (p[0][m], p[1][m])
                                         for p in halos[1:])
                mkw = dict(kw, ec=ec[m]) if use_ec else kw
                return fused.fused_stages_const_3d(
                    V, O, b[m], None if xx is None else xx[m], corner=corner, halos=mh,
                    **mkw)

            outs = (("r",) if not kw.get("emit_x", True)
                    else ("x", "r") if kw.get("emit_residual") else ("x",))
            nb, fl = k1_bound(mode, n, nc, len(O))
            halo_bytes = 4 * int(np.prod(plane)) * 2 * D * (2 if has_x else 1)
            row = batch_case(
                f"K1hb {mode} {tag}", outs,
                functools.partial(fused.fused_stages_const_3d_batch, V, O, b, xx,
                                  corner=corner, halos=halos, **bkw),
                run_m,
                functools.partial(fused.fused_stages_const_3d_batch_plain, V, O, b, xx,
                                  corner=gated, halos=halos, **bkw),
                b, K, (nb + halo_bytes, fl), copy_bw)
            row.update(level=tag, mode=mode, depth=D, shape=[K, *slab])
            rows["K1hb"].append(row)
            del halos
        del b, x, lo, hi, ec
        torch.cuda.empty_cache()
    # K2hb on 256³ / P
    L0 = h.levels[0]
    slab = (BIG[0] // P,) + BIG[1:]
    plane = slab[1:]
    n = int(np.prod(slab))
    terms = exact_residual_terms(h)
    arrs = [randn_card((K,) + slab, 81 + j, dev, sc)
            for j, sc in enumerate((1.0, 1e-8, 1e-3, 1.0, 1e-8))]
    halos = tuple((randn_card((K, 1) + plane, 86 + j, dev, sc),
                   randn_card((K, 1) + plane, 89 + j, dev, sc))
                  for j, sc in enumerate((1.0, 1e-8, 1e-3)))
    O = L0.A.offsets

    def k2b():
        return kernels.df_update_residual_batch(O, terms, *arrs, emit_norm=True,
                                                halos=halos)

    got = k2b()
    ref = kernels.df_update_residual_batch_plain(O, terms, *arrs, True, halos)
    for j, name in enumerate(("x_hi", "x_lo", "r_hi")):
        if not torch.equal(got[j], ref[j]):
            fail(f"K2hb {name}: not bit-equal to the batched plain version")
    for m in range(K):
        pn, pw = float(got[3][m].double().sum()), float(ref[3][m].double().sum())
        if abs(pn - pw) > 1e-6 * pw:
            fail(f"K2hb member {m}: ‖r‖² {pn} against the plain version's {pw}")
    del got, ref
    nb, fl = k2_bound(n, terms, True)
    row = batch_case(
        "K2hb 256^3 constant", ("x_hi", "x_lo", "r_hi"), lambda: k2b()[:3],
        lambda m: kernels.df_update_residual_const_3d(
            O, terms, *[a[m] for a in arrs], emit_norm=True,
            halos=tuple((p[0][m], p[1][m]) for p in halos))[:3],
        lambda: kernels.df_update_residual_batch_plain(O, terms, *arrs, True, halos)[:3],
        arrs[3], K, (nb + 24 * int(np.prod(plane)), fl), copy_bw)
    row.update(level="256^3 constant", mode="emit_norm", shape=[K, *slab],
               bit_equal_to_plain=True)
    rows["K2hb"].append(row)
    del arrs, halos
    # K4hb: a pass on the 256³ diffusion slab, its coefficient grids shared
    Lv = h_vary.levels[0]
    op = Lv.A
    slab = (Lv.grid_shape[0] // P,) + tuple(Lv.grid_shape[1:])
    plane = slab[1:]
    n = int(np.prod(slab))
    cs = op.coeffs[:, slab[0]:2 * slab[0]].contiguous()
    b, x = randn_card((K,) + slab, 92, dev), randn_card((K,) + slab, 93, dev)
    lo, hi = randn_card((K, 1) + plane, 94, dev), randn_card((K, 1) + plane, 95, dev)
    for mode, kmode, color in (("rb colour 0", "rbgs", 0), ("residual", "residual", 0)):
        args = (cs, op.offsets, b, x, kmode, OMEGA, color, lo, hi)
        full = sweep_bound(n, op.offsets, True, kmode)
        own = sweep_bound(n, op.offsets, False, kmode)
        per = own[0] + 8 * int(np.prod(plane))
        row = batch_case(
            f"K4hb {mode}", ("r",) if kmode == "residual" else ("x",),
            functools.partial(kernels.halo_half_sweep_vary_batch, *args),
            lambda m, kmode=kmode, color=color: kernels.halo_half_sweep_vary_3d(
                cs, op.offsets, b[m], x[m], kmode, OMEGA, color, lo[m], hi[m]),
            functools.partial(kernels.halo_half_sweep_vary_batch_plain, *args),
            b, K, (per, full[1]), copy_bw,
            bound_batch=(K * per + full[0] - own[0], K * full[1]))
        row.update(level="256^3 diffusion", mode=mode, shape=[K, *slab])
        rows["K4hb"].append(row)
    del b, x, lo, hi, cs
    launched = halo_batch_counts()
    if not all(launched[k] for k in ("K1hb", "K2hb", "K3hb", "K4hb")):
        fail(f"halo_kernels (batch): launches {launched}")
    rows["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return rows


def sparse_halo_counts():
    from openmg_tpu_torch.ops import ell

    return {**sparse_counts(), "K6_halo": ell.LAUNCHES_K6H}


def sparse_matrix(kind, shape):
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.models.spd import irregular_spd

    if kind == "poisson":
        return mg.poisson(shape)
    return irregular_spd(int(np.prod(shape)), couplings=IRREGULAR_COUPLINGS)


def sparse_rhs(n, seed, dev):
    """``models.spd.unit_rhs(n, seed)`` as a float32 card tensor
    (``solve_sparse``'s right-hand sides)."""
    from openmg_tpu_torch.models.spd import unit_rhs

    return torch.from_numpy(unit_rhs(n, seed).astype(np.float32)).to(dev)


def model_check(solver, stats, cycles, sparse):
    """The communication model of ``solver`` against what its ``Comm``
    counted over a solve of ``cycles`` cycles from zero: bytes sent, staged
    and gathered, equal."""
    from openmg_tpu_torch.parallel.model import comm_model, comm_model_sparse

    m = (comm_model_sparse if sparse else comm_model)(solver)
    want = {
        "bytes_sent": cycles * m["halo_bytes_per_cycle"],
        "staged_bytes": cycles * m["staged_bytes_per_cycle"],
        "gathered_bytes": cycles * m["gathered_bytes_per_cycle"]
        + m["delivery_gathered_bytes"],
    }
    return {
        "model_halo_bytes_per_cycle": m["halo_bytes_per_cycle"],
        "model_staged_bytes_per_cycle": m["staged_bytes_per_cycle"],
        "model_gathered_bytes_per_cycle": m["gathered_bytes_per_cycle"],
        "model_hbm_bytes_per_cycle": m["hbm_bytes_per_cycle"],
        "model_efficiency_bound_no_overlap": m["efficiency_bound_no_overlap"],
        "model_matches_comm_stats": all(stats[k] == v for k, v in want.items()),
        "model_expected_stats": want,
    }


def dist_rank(argv):
    """One rank of ``solve_dist`` (``chip_smoke.py --dist-rank RANK WORLD
    STORE CASES OUT``): joins the group, runs the cases, and on rank 0
    writes the results (and the solutions) for the parent.  A sparse case
    reuses the host hierarchy of the rank's previous case of the same
    matrix, shape and hierarchy settings (``sparse_dist.hierarchy_settings``:
    everything of the config that the build reads)."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import ell
    from openmg_tpu_torch.parallel.sparse_dist import hierarchy_settings
    from openmg_tpu_torch.parallel.mesh import initialize_distributed

    rank, world, store, cases_path, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    spec = json.loads(open(cases_path).read())
    dev = torch.device(spec["device"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    initialize_distributed(init_method="file://" + store, rank=rank,
                           world_size=world, backend=spec["backend"], device=dev)
    results = []
    hierarchies = {}
    for case in spec["cases"]:
        cfg = mg.SolverConfig(**case["config"])
        mc = mg.MeshConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in case["mesh"].items()})
        shape = tuple(case["shape"])
        sparse = case["problem"] == "sparse"
        t0 = time.perf_counter()
        if sparse:
            key = (case["matrix"], tuple(shape),
                   tuple(sorted(hierarchy_settings(cfg).items())))
            if key in hierarchies:
                solver = mg.DistributedAlgebraicSolver(hierarchies[key], cfg, mc, device=dev)
            else:
                solver = mg.setup_sparse_distributed(
                    sparse_matrix(case["matrix"], shape), shape, cfg, mc, device=dev)
                hierarchies[key] = solver.hierarchy
            b = sparse_rhs(solver.n, case["seed"], dev)
        else:
            if case["problem"] == "diffusion":
                problem = mg.diffusion_stencil(medium(shape))
            else:
                problem = shape
            solver = mg.distributed_setup(problem, cfg, mc, device=dev)
            b = main_rhs(shape, dev)
        sync()
        setup_s = time.perf_counter() - t0
        x1, info1 = solver.solve(b)   # the first: the library loads
        sync()
        zero_counts()
        zero_halo_counts()
        ell.LAUNCHES_K6H = 0
        solver.comm.reset_stats()
        torch.distributed.barrier()
        x, info = solver.solve(b)
        sync()
        launched = {**counts(), **halo_counts(), **sparse_halo_counts()}
        stats = dict(solver.comm.stats)
        cycles = info["cycles"]
        res = {
            "name": case["name"], "ranks": world, "mesh": case["mesh"],
            "backend": spec["backend"], "transport": solver.comm.transport,
            "partition_plan": list(info["partition_plan"]),
            "cycles": cycles, "final_norm": info["final_norm"],
            "residual_norms": info["residual_norms"], "converged": info["converged"],
            "launches_rank0": {k: v for k, v in launched.items() if v},
            "halo_bytes_sent_per_cycle": stats["bytes_sent"] / max(cycles, 1),
            # the halo planes' copies through the host (to and from), not the
            # gathers (the coarse transition, and the whole solution's at
            # the end, which a solve delivers on every rank)
            "halo_staged_bytes_per_cycle": stats["staged_bytes"] / max(cycles, 1),
            "gathered_bytes": stats["gathered_bytes"],
            "exchanges_per_cycle": stats["exchanges"] / max(cycles, 1),
            "comm_stats": stats,
            **model_check(solver, stats, cycles, sparse),
            "host_reads": info["host_reads"],
            "setup_s": setup_s,
            "first_solve_ms": info1["solve_time_s"] * 1e3,
            "warm_solve_ms": info["solve_time_s"] * 1e3,
            "warm_solve_ms_is": f"one card shared by {world} ranks over "
                                f"{spec['backend']}: not a scaling figure",
            "equal_to_first_solve": bool(torch.equal(x, x1)),
        }
        if rank == 0:
            hi, lo = info["x_df"]
            x64 = hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)
            np.save(f"{out}_{case['name']}.npy", x64)
        del x, x1, info, info1
        if case.get("many"):
            res["many"] = many_in_rank(solver, case, sparse, dev, sync, rank,
                                       f"{out}_{case['name']}_many.npy")
        if rank == 0:
            results.append(res)
        del solver, b
        torch.cuda.empty_cache()
    if rank == 0:
        with open(out + ".json", "w") as f:
            json.dump(results, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def all_launch_counts():
    """Every launch counter of the port: scalar, batched, halo and halo on
    a batch."""
    return {**counts(), **batch_counts(), **halo_counts(), **sparse_halo_counts(),
            **halo_batch_counts()}


def zero_all_counts():
    from openmg_tpu_torch.ops import ell

    zero_counts()
    zero_halo_counts()
    zero_halo_batch_counts()
    ell.LAUNCHES_K6H = 0


# a scalar launch counter and its form on a batch
BATCH_TWIN = {"K1": "K1b", "K2": "K2b", "K3": "K3b", "K4": "K4b", "K5": "K5b",
              "K6": "K6b", "K7": "K7b", "K1_halo": "K1hb", "K2_halo": "K2hb",
              "K3_halo": "K3hb", "K4_halo": "K4hb", "K6_halo": "K6hb"}


def many_rhs(solver, case, sparse, dev, K):
    """The float32 card batch of ``solve_many_dist``: seeds 1 … K, each
    normalised (``main_rhs`` / ``sparse_rhs``, the scalar cases' own)."""
    if sparse:
        return torch.stack([sparse_rhs(solver.n, sd, dev) for sd in range(1, K + 1)])
    return torch.stack([main_rhs(tuple(case["shape"]), dev, sd) for sd in range(1, K + 1)])


def many_in_rank(solver, case, sparse, dev, sync, rank, path):
    """``solve_many_dist`` in a rank of ``solve_dist``, on that case's
    solver: the scalar solve of each of the K members, then
    ``solve_many`` of the K as one card batch.  Every member must have
    converged with its scalar solve's norm history and iterate pair bit for
    bit, the batch one host read a step, the exchanges of the longest
    member's scalar solve, the bytes sent, staged and gathered of all its
    members', and launches of the kernels' forms on a batch only (each
    scalar form the scalar solves launched has its batched twin launched).
    Rank 0 writes the members' merged iterates to ``path``."""
    K = case["many"]
    bt = many_rhs(solver, case, sparse, dev, K)
    sync()
    scalars = []
    for m in range(K):
        zero_all_counts()
        solver.comm.reset_stats()
        torch.distributed.barrier()
        _, im = solver.solve(bt[m])
        sync()
        scalars.append({"pair": im["x_df"], "hist": im["residual_norms"],
                        "ms": im["solve_time_s"] * 1e3, "stats": dict(solver.comm.stats),
                        "launched": all_launch_counts()})
    zero_all_counts()
    solver.comm.reset_stats()
    torch.distributed.barrier()
    _, info = solver.solve_many(bt)
    sync()
    launched = all_launch_counts()
    stats = dict(solver.comm.stats)
    bad = []
    for m, sc in enumerate(scalars):
        pair = tuple(t[m] for t in info["x_df"])
        if not (torch.equal(pair[0], sc["pair"][0]) and torch.equal(pair[1], sc["pair"][1])):
            bad.append(f"member {m}: iterate not bit-equal to its scalar solve")
        if info["residual_norms"][m] != sc["hist"]:
            bad.append(f"member {m}: norms {info['residual_norms'][m]} against {sc['hist']}")
    if not all(info["converged"]):
        bad.append(f"converged {info['converged']}")
    steps = max(info["cycles"])
    if info["host_reads"] != steps + 1:
        bad.append(f"{info['host_reads']} host reads for {steps} steps")
    if stats["exchanges"] != max(sc["stats"]["exchanges"] for sc in scalars):
        bad.append(f"exchanges {stats['exchanges']} against the scalar solves' "
                   f"{[sc['stats']['exchanges'] for sc in scalars]}")
    sums = {k: sum(sc["stats"][k] for sc in scalars)
            for k in ("bytes_sent", "staged_bytes", "gathered_bytes")}
    if any(stats[k] != v for k, v in sums.items()):
        bad.append(f"bytes {stats} against the members' sums {sums}")
    scalar_kinds = {k for sc in scalars for k, v in sc["launched"].items()
                    if v and k in BATCH_TWIN}
    if any(launched[k] for k in BATCH_TWIN):
        bad.append(f"scalar launches in the batch: {launched}")
    if any(not launched[BATCH_TWIN[k]] for k in scalar_kinds):
        bad.append(f"the batch launched {launched}, the scalar solves {sorted(scalar_kinds)}")
    if rank == 0:
        hi, lo = info["x_df"]
        np.save(path, hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64))
    scalar_ms = [sc["ms"] for sc in scalars]
    return {
        "K": K, "cycles": info["cycles"], "converged": info["converged"],
        "final_norm": info["final_norm"], "host_reads": info["host_reads"],
        "bit_equal_to_scalar_solves": not bad, "faults": bad,
        "exchanges_per_step": stats["exchanges"] / max(steps, 1),
        "scalar_exchanges_per_step": [sc["stats"]["exchanges"] / max(len(sc["hist"]) - 1, 1)
                                      for sc in scalars],
        "comm_stats": stats, "members_comm_stats_sums": sums,
        "launches_rank0": {k: v for k, v in launched.items() if v},
        "scalar_launches_rank0": {k: sum(sc["launched"][k] for sc in scalars)
                                  for k in sorted(scalar_kinds)},
        "ms": info["solve_time_s"] * 1e3, "ms_per_rhs": info["solve_time_s"] * 1e3 / K,
        "scalar_ms": scalar_ms, "scalar_ms_mean": sum(scalar_ms) / K,
        "ms_is": "warm, on one card shared by the ranks: not a scaling figure",
        "x_path": path,
    }


def spawn_ranks(world, backend, cases, tmp, device="cuda:0"):
    """Run ``cases`` on ``world`` ranks of this script, each its own
    process on the one card; every rank must exit 0 within
    ``DIST_TIMEOUT_S``.  Returns rank 0's results."""
    tag = f"{backend}{world}"
    store = os.path.join(tmp, f"store_{tag}")
    cases_path = os.path.join(tmp, f"cases_{tag}.json")
    out = os.path.join(tmp, f"out_{tag}")
    with open(cases_path, "w") as f:
        json.dump({"backend": backend, "device": device, "cases": cases}, f)
    logs, procs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank_{tag}_{r}.log"), "w")
        logs.append(log)
        env = dict(os.environ, LOCAL_RANK="0", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
             str(world), store, cases_path, out],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.perf_counter())))
    except subprocess.TimeoutExpired:
        rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rc != 0 for rc in rcs) or len(rcs) != world:
        tails = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank_{tag}_{r}.log")) as f:
                tails.append(f"--- rank {r}:\n" + f.read()[-3000:])
        fail(f"solve_dist {tag}: ranks exited {rcs}\n" + "\n".join(tails))
    with open(out + ".json") as f:
        results = json.load(f)
    for res in results:
        res["x_path"] = f"{out}_{res['name']}.npy"
    return results


def lambda_min_poisson(shape):
    """The least eigenvalue of the Dirichlet 7-point Poisson operator
    (diagonal 6, neighbours −1) on ``shape``."""
    return sum(2.0 - 2.0 * math.cos(math.pi / (n + 1)) for n in shape)


# solve_sparse_dist: the 1024² ELL solve of solve_sparse (its right-hand side
# of seed 2) and the gathered-x tier at SPARSEDIST_r05.json's size
ELL_DIST_CFG = dict(format="ell", transfer="linear", smoother="rbgs",
                    max_dense_coarse=4096, threshold=1e-10,
                    residual_dtype="doublefloat", cycles=60)
ELL_SEED = 2
IRREGULAR_N = 262144
IRREGULAR_COUPLINGS = 8  # SPARSEDIST_r05.json's matrix
IRREGULAR_CFG = dict(format="ell", residual_dtype="doublefloat", cycles=60)
IRREGULAR_SEED = 3


def gershgorin_lambda_min(A):
    """A lower bound of the least eigenvalue of the symmetric matrix ``A``:
    min_i (a_ii − Σ_{j≠i} |a_ij|).  Where it is positive, 2e-10 over it
    bounds ‖Δx‖₂ of two solutions within 1e-10 of one system (loosely: the
    bound is the larger).  For the irregular matrix it is within 2 % of
    the least eigenvalue, which shift-invert Lanczos cannot resolve in
    minutes at 262,144 rows (its lowest eigenvalues cluster)."""
    d = A.diagonal()
    off = np.asarray(abs(A).sum(axis=1)).ravel() - np.abs(d)
    return float(np.min(d - off))


def merged_pair(info):
    hi, lo = info["x_df"]
    return hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)


def sparse_dist_refs(dev, solvers):
    """The single-device solves on the card that ``solve_sparse_dist`` holds
    its distributed solves against: V and PCG(2) on ``solve_sparse``'s 1024²
    ELL hierarchy, and the 262,144-row irregular matrix (red/black by its
    greedy colours, aggregate transfers: the defaults)."""
    import openmg_tpu_torch as mg
    from openmg_tpu_torch.ops import ell

    h = solvers["ell"].hierarchy
    b = sparse_rhs(h.n, ELL_SEED, dev)
    out = {"ell_lambda_min": sum(4.0 * np.sin(np.pi / (2 * (m + 1))) ** 2
                                 for m in ELL_SHAPE)}
    for name, cfg in (("v", ELL_DIST_CFG), ("pcg", dict(ELL_DIST_CFG, **INNER_KW["pcg"]))):
        zero_counts()
        _, info = mg.AlgebraicSolver(h, mg.SolverConfig(**cfg)).solve(b)
        torch.cuda.synchronize()
        out[name] = {"x": merged_pair(info), "cycles": info["cycles"],
                     "K6_per_cycle": ell.LAUNCHES_K6 / info["cycles"],
                     "converged": info["converged"]}
    # solve_many_dist's ELL members: the single-device solve_many of seeds 1 … K
    K = MANY_DIST["ell_v_P2"]
    bt = torch.stack([sparse_rhs(h.n, sd, dev) for sd in range(1, K + 1)])
    _, info = mg.AlgebraicSolver(h, mg.SolverConfig(**ELL_DIST_CFG)).solve_many(bt)
    torch.cuda.synchronize()
    if not all(info["converged"]):
        fail("solve_sparse_dist: the single-device ELL solve_many did not converge")
    out["many"] = {"x": merged_pair(info), "cycles": info["cycles"]}
    A = sparse_matrix("irregular", (IRREGULAR_N,))
    t0 = time.perf_counter()
    solver = mg.setup_sparse(A, (IRREGULAR_N,), mg.SolverConfig(**IRREGULAR_CFG), device=dev)
    setup_s = time.perf_counter() - t0
    _, info = solver.solve(sparse_rhs(IRREGULAR_N, IRREGULAR_SEED, dev))
    out["irregular"] = {"x": merged_pair(info), "cycles": info["cycles"],
                        "converged": info["converged"], "setup_s": setup_s,
                        "lambda_min_lower_bound": gershgorin_lambda_min(A),
                        "plan_levels": len(solver.hierarchy.levels)}
    for k in ("v", "pcg", "irregular"):
        if not out[k]["converged"]:
            fail(f"solve_sparse_dist: the single-device {k} solve did not converge")
    return out


def phase_k6h(dev, copy_bw, h_ell, P=HALO_SLABS, reps=20):
    """K6h on the 1024² ELL hierarchy's level 0 (k 5, H = 1024) and its k-9
    512² level (H = 513) cut into ``P`` row blocks, each block's halos cut
    from its neighbours (zeros at the domain's edges): every block against
    the plain version and the whole-vector K6's rows (bit for bit by design;
    failing beyond K6's tolerance); device ms of an inner block (each call
    on another copy of its operands) beside the whole vector's / P, the
    block's bound, the plain version's time and ``torch.mv`` of the block's
    rows (``block_library``).  On each level's inner block K6hb at K =
    ``BATCH_K`` too (``k6hb_row``).  Returns the K6h and the K6hb rows."""
    from openmg_tpu_torch.ops import ell

    rows, rows_b = [], []
    for tag, lv in (("1024^2 level 0", 0), ("512^2 level 1 (k 9)", 1)):
        M = h_ell.levels[lv].A
        offs = M.slot_offsets
        n, k = M.shape[0], M.k
        m, H = n // P, ell.band_halo(offs)
        x = randn((n,), 40 + lv, dev)
        terms = ell.spmv_banded_plain(M.data.abs(), offs, x.abs())
        scale = float(terms.max())
        blocks = [(M.data[:, i * m:(i + 1) * m].contiguous(),) + cut(x, i, P, H, H)
                  for i in range(P)]
        whole = ell.spmv_ell(M, x)
        worst_plain = worst_whole = 0.0
        bit_plain = bit_whole = True
        for i, (d, xs, lo, hi) in enumerate(blocks):
            got = ell.spmv_banded_halo(d, offs, xs, lo, hi)
            ref = ell.spmv_banded_halo_plain(d, offs, xs, lo, hi)
            torch.cuda.synchronize()
            if got.shape != (m,) or not bool(torch.isfinite(got).all()):
                fail(f"K6h {tag} block {i}: bad output")
            w = whole[i * m:(i + 1) * m]
            e_plain = float((got - ref).abs().max())
            e_whole = float((got - w).abs().max())
            bit_plain &= bool(torch.equal(got, ref))
            bit_whole &= bool(torch.equal(got, w))
            worst_plain, worst_whole = max(worst_plain, e_plain), max(worst_whole, e_whole)
            if max(e_plain, e_whole) > SPARSE_TOL * scale:
                fail(f"K6h {tag} block {i}: err {e_plain:.3e} against the plain version, "
                     f"{e_whole:.3e} against K6's rows (tolerance {SPARSE_TOL * scale:.3e})")
        es = x.element_size()
        nbytes = (k * m + m + 2 * H + m) * es
        flops = 2 * k * m
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        # copies of the inner blocks' operands, so that each call reads them
        # from device memory; and of the whole vector's
        inner = [blocks[i] for i in range(1, P - 1)]
        ops = [tuple(t.clone() for t in inner[c % len(inner)])
               for c in range(max(len(inner), operand_copies(nbytes)))]
        wops = [(dataclasses.replace(M, data=M.data.clone()), x.clone())
                for _ in range(operand_copies((M.data.numel() + 2 * n) * es))]
        d1, x1, lo1, hi1 = blocks[1]
        before = ell.LAUNCHES_K6H
        rows.append({
            "level": tag, "mode": f"inner block of {P}", "shape": [m], "k": k, "H": H,
            "bit_equal_to_plain": bit_plain,
            "bit_equal_to_whole_vector_kernel": bit_whole,
            "max_abs_err": worst_plain, "max_abs_err_vs_whole_vector_kernel": worst_whole,
            "tolerance": SPARSE_TOL * scale,
            "ms": device_ms([functools.partial(ell.spmv_banded_halo, d, offs, xs, lo, hi)
                             for d, xs, lo, hi in ops], reps),
            "whole_ms_over_P": device_ms([functools.partial(ell.spmv_ell, Mc, xc)
                                          for Mc, xc in wops], reps) / P,
            "ms_l2_warm": device_ms([functools.partial(ell.spmv_banded_halo, d1, offs,
                                                       x1, lo1, hi1)], reps),
            "plain_ms": time_ms(lambda: ell.spmv_banded_halo_plain(d1, offs, x1, lo1, hi1),
                                3, warm=1),
            "operand_copies": len(ops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_copy_bw": nbytes / copy_bw * 1e3, "bytes": nbytes, "flops": flops,
            **block_library(d1, offs, H, x1[None], lo1[None], hi1[None], scale),
        })
        if ell.LAUNCHES_K6H == before:
            fail("K6h: the timed calls launched nothing")
        del ops, wops, whole, terms
        rows_b.append(k6hb_row(tag, M, blocks[1], dev, copy_bw, scale))
        del blocks
    torch.cuda.empty_cache()
    return rows, rows_b


def block_csr(data, offs, H):
    """A row block's true nonzeros as a ``torch.sparse`` CSR matrix of ``m``
    rows against ``[lo; x; hi]`` (``m + 2H`` columns): the library
    yardstick's operand."""
    k, m = data.shape
    r = torch.arange(m, device=data.device)
    live = [data[j] != 0 for j in range(k)]
    rows = torch.cat([r[lv] for lv in live])
    cols = torch.cat([(r + int(d) + H)[lv] for d, lv in zip(offs, live)])
    vals = torch.cat([data[j][lv] for j, lv in enumerate(live)])
    A = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (m, m + 2 * H))
    return A.coalesce().to_sparse_csr()


def block_library(data, offs, H, X, lo, hi, scale, reps=20):
    """The library call beside K6h (one member, ``torch.mv``) and K6hb (K
    members, ``torch.sparse.mm`` with an ``(m + 2H, K)`` block): the block's
    rows against ``[lo; x; hi]`` (made beforehand), its device ms, held
    against K6h's plain version; the port never calls it."""
    from openmg_tpu_torch.ops import ell

    A = block_csr(data, offs, H)
    xe = torch.cat([lo, X, hi], dim=1)
    K = X.shape[0]
    ref = torch.stack([ell.spmv_banded_halo_plain(data, offs, X[m], lo[m], hi[m])
                       for m in range(K)])
    if K == 1:
        v = xe[0].contiguous()
        got = torch.mv(A, v)[None]
        ms = device_ms([lambda: torch.mv(A, v)], reps)
        what = "torch.mv(CSR of the block's true nonzeros, [lo; x; hi])"
    else:
        xt = xe.t().contiguous()
        got = torch.sparse.mm(A, xt).t()
        ms = device_ms([lambda: torch.sparse.mm(A, xt)], reps)
        what = "torch.sparse.mm(CSR of the block's true nonzeros, (m + 2H, K) block)"
    err = float((got - ref).abs().max())
    if not err <= 1e-5 * scale:
        fail(f"{what}: differs from the plain version by {err:.3e}")
    return {"library_ms": ms, "library": what, "library_max_abs_err": err}


def k6hb_row(tag, M, block, dev, copy_bw, scale, reps=20):
    """K6hb at K = ``BATCH_K`` on the inner block ``block`` of ``phase_k6h``
    (its slot planes; each member's x and received rows drawn on the card):
    against its batched plain version and member by member against K6h, bit
    for bit; device ms on rotating copies beside K launches of K6h, the
    batched bound (the slot planes once, K × (x, the 2H rows, y)) and
    ``torch.sparse.mm`` of the block's rows."""
    from openmg_tpu_torch.ops import ell

    K = BATCH_K
    d = block[0]
    offs, H, m, k = M.slot_offsets, ell.band_halo(M.slot_offsets), d.shape[1], d.shape[0]
    X = randn_card((K, m), 47, dev)
    lo, hi = randn_card((K, H), 48, dev), randn_card((K, H), 49, dev)
    got = ell.spmv_banded_halo_batch(d, offs, X, lo, hi)
    ref = ell.spmv_banded_halo_batch_plain(d, offs, X, lo, hi)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if got.shape != (K, m) or not err <= SPARSE_TOL * scale:
        fail(f"K6hb {tag}: err {err:.3e} > {SPARSE_TOL * scale:.3e}")
    for i in range(K):
        if not torch.equal(got[i], ell.spmv_banded_halo(d, offs, X[i], lo[i], hi[i])):
            fail(f"K6hb {tag}: member {i} is not bit-equal to K6h")
    es = X.element_size()
    nbytes = (k * m + K * (2 * m + 2 * H)) * es
    flops = 2 * K * k * m
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    ops = [(d, X, lo, hi)] + [tuple(t.clone() for t in (d, X, lo, hi))
                              for _ in range(operand_copies(nbytes) - 1)]
    ms = device_ms([functools.partial(ell.spmv_banded_halo_batch, dc, offs, Xc, lc, hc)
                    for dc, Xc, lc, hc in ops], reps)
    scalar_ms = device_ms([functools.partial(ell.spmv_banded_halo, ops[i % len(ops)][0],
                                             offs, *(t[i] for t in ops[i % len(ops)][1:]))
                           for i in range(K)], 2 * K)
    row = {
        "level": tag, "mode": f"inner block of {HALO_SLABS}", "K": K, "shape": [K, m],
        "k": k, "H": H, "bit_equal_to_plain": bool(torch.equal(got, ref)),
        "bit_equal_to_scalar_per_member": True, "max_abs_err": err,
        "tolerance": SPARSE_TOL * scale, "ms": ms, "ms_per_member": ms / K,
        "scalar_ms": scalar_ms, "K_times_scalar_ms": K * scalar_ms,
        "batch_over_scalar": ms / (K * scalar_ms),
        "plain_ms": time_ms(lambda: ell.spmv_banded_halo_batch_plain(d, offs, X, lo, hi),
                            3, warm=1),
        "operand_copies": len(ops), "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_ms_copy_bw": nbytes / copy_bw * 1e3, "bytes": nbytes, "flops": flops,
        **block_library(d, offs, H, X, lo, hi, scale),
    }
    del got, ref, ops
    return row


def phase_solve_dist(dev, copy_bw, sparse_refs, k6h_rows):
    """The 256³ main-path solve on P = 2 and P = 4 ranks sharing the card
    (gloo, planes staged through the host), PCG(2) on a (2, 2) mesh, the
    128³ diffusion solve on two ranks (K4's halo form), and the one-rank
    NCCL solve with every level partitioned (zero halos), each against the
    single-device solve on the card (``solve_dist``); in the same spawns the
    distributed sparse solves (``solve_sparse_dist``).  Every solve's
    ``Comm.stats`` must equal its communication model's.  After their
    scalar solves the ranks of the cases in ``MANY_DIST`` run
    ``solve_many`` of K right-hand sides on the same solvers
    (``solve_many_dist``: ``many_in_rank``, ``many_dist_check``)."""
    import tempfile

    import openmg_tpu_torch as mg

    # the single-device solutions to hold the ranks' against (and, for
    # solve_many_dist, the single-device solve_many of seeds 1 … K)
    b = main_rhs(BIG, dev)
    single = mg.setup(BIG, mg.SolverConfig(**MAIN_CFG), device=dev)
    _, info = single.solve(b)
    x_single = merged_pair(info)
    single_cycles = info["cycles"]
    many_refs = {"v": single_many(single, BIG, MANY_DIST["v_P1_nccl_forced"], dev)}
    pcg = mg.setup(BIG, mg.SolverConfig(**MAIN_CFG, krylov="pcg", krylov_iters=2),
                   device=dev)
    _, info = pcg.solve(b)
    x_pcg = merged_pair(info)
    many_refs["pcg"] = single_many(pcg, BIG, MANY_DIST["pcg2_mesh2x2"], dev)
    del single, pcg, b, info
    bd = main_rhs(DIFFUSION_DIST, dev)
    dsolver = mg.setup(mg.diffusion_stencil(medium(DIFFUSION_DIST)),
                       mg.SolverConfig(**MAIN_CFG), device=dev)
    _, info = dsolver.solve(bd)
    x_diff = merged_pair(info)
    diff_cycles = info["cycles"]
    many_refs["diffusion"] = single_many(dsolver, DIFFUSION_DIST,
                                         MANY_DIST["diffusion_P2"], dev)
    many_refs["ell"] = sparse_refs["many"]
    del dsolver, bd, info
    torch.cuda.empty_cache()

    bound = 2e-10 / lambda_min_poisson(BIG)
    v_case = dict(problem="poisson", shape=list(BIG), config=MAIN_CFG)
    ell_case = dict(problem="sparse", matrix="poisson", shape=list(ELL_SHAPE),
                    config=ELL_DIST_CFG, seed=ELL_SEED)
    ell_pcg = dict(ELL_DIST_CFG, **INNER_KW["pcg"])
    forced = {"n_devices": 1, "force_partition": True}
    plans = {
        2: [dict(v_case, name="v_P2", mesh={"n_devices": 2}),
            dict(problem="diffusion", shape=list(DIFFUSION_DIST), config=MAIN_CFG,
                 name="diffusion_P2", mesh={"n_devices": 2}),
            dict(ell_case, name="ell_v_P2", mesh={"n_devices": 2})],
        4: [dict(v_case, name="v_P4", mesh={"n_devices": 4}),
            dict(v_case, name="pcg2_mesh2x2",
                 config=dict(MAIN_CFG, krylov="pcg", krylov_iters=2),
                 mesh={"mesh_shape": [2, 2]}),
            dict(ell_case, name="ell_v_P4", mesh={"n_devices": 4}),
            dict(ell_case, name="ell_pcg2_mesh2x2", config=ell_pcg,
                 mesh={"mesh_shape": [2, 2]})],
    }
    for cases in plans.values():
        for c in cases:
            c["many"] = MANY_DIST.get(c["name"])
    nccl = [dict(v_case, name="v_P1_nccl_forced", mesh=forced,
                 many=MANY_DIST["v_P1_nccl_forced"]),
            dict(ell_case, name="ell_v_P1_nccl_forced", mesh=forced,
                 many=MANY_DIST["ell_v_P1_nccl_forced"]),
            dict(problem="sparse", matrix="irregular", shape=[IRREGULAR_N],
                 config=IRREGULAR_CFG, seed=IRREGULAR_SEED,
                 name="irregular_P1_nccl_forced", mesh=forced)]
    ell_bound = 2e-10 / sparse_refs["ell_lambda_min"]
    out, sparse_out, many_out = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(P, "gloo", plans[P]) for P in DIST_RANKS]
        runs.append((1, "nccl", nccl))
        for world, backend, cases in runs:
            t0 = time.perf_counter()
            for res in spawn_ranks(world, backend, cases, tmp):
                xd = np.load(res.pop("x_path"))
                name = res["name"]
                if res.get("many"):
                    many_out[name] = many_dist_check(name, res.pop("many"), many_refs,
                                                     bound, ell_bound)
                launched = res["launches_rank0"]
                if not res["model_matches_comm_stats"]:
                    fail(f"solve_dist {name}: Comm.stats {res['comm_stats']}, the model "
                         f"{res['model_expected_stats']}")
                if not res["converged"] or not res["final_norm"] < 1e-10:
                    fail(f"solve_dist {name}: {res['residual_norms']}")
                if not res["equal_to_first_solve"]:
                    fail(f"solve_dist {name}: the warm solve differs from the first")
                if name.startswith(("ell", "irregular")):
                    sparse_check(name, res, xd, sparse_refs, ell_bound)
                    sparse_out[name] = res
                    continue
                if name.startswith("diffusion"):
                    ref, want_cycles, key = x_diff, diff_cycles, "K4_halo"
                elif name.startswith("pcg"):
                    ref, want_cycles, key = x_pcg, None, "K1_halo"
                else:
                    ref, want_cycles, key = x_single, single_cycles, "K1_halo"
                diff = float(np.linalg.norm((xd - ref).ravel()))
                res["norm_x_dist_minus_x_single"] = diff
                res["single_device_cycles"] = want_cycles
                if want_cycles is not None and res["cycles"] != want_cycles:
                    fail(f"solve_dist {name}: {res['cycles']} cycles, the single-"
                         f"device solve {want_cycles}")
                if name.startswith("pcg") and res["cycles"] > PCG_RECORD_OUTER:
                    fail(f"solve_dist {name}: {res['cycles']} outer steps")
                if not name.startswith("diffusion"):
                    res["bound_2e-10_over_lambda_min"] = bound
                    if not diff <= bound:
                        fail(f"solve_dist {name}: ‖x_dist − x_single‖ = {diff:.3e} "
                             f"> {bound:.3e}")
                if not launched.get(key):
                    fail(f"solve_dist {name}: launches {launched}")
                out[name] = res
            out[f"spawn_{backend}{world}_s"] = time.perf_counter() - t0
    # the card's analogue of the JAX package's calibration: the model's
    # memory bytes a cycle over the bytes the measured cycle time moves at
    # the copy bandwidth of this run
    calibration = {}
    for name, res in (("256^3 stencil, v_P1_nccl_forced", out["v_P1_nccl_forced"]),
                      ("1024^2 ELL, ell_v_P1_nccl_forced",
                       sparse_out["ell_v_P1_nccl_forced"])):
        ms_cycle = res["warm_solve_ms"] / res["cycles"]
        calibration[name] = {
            "model_hbm_bytes_per_cycle": res["model_hbm_bytes_per_cycle"],
            "warm_ms_per_cycle": ms_cycle, "copy_bytes_per_s": copy_bw,
            "ratio_model_over_time_x_bw": res["model_hbm_bytes_per_cycle"]
            / (ms_cycle * 1e-3 * copy_bw),
        }
    emit("solve_dist", out)
    emit("solve_many_dist", {
        "cases": many_out, "seconds_in_ranks": {
            name: (r["ms"] + sum(r["scalar_ms"])) / 1e3 for name, r in many_out.items()},
        "checks": "every member converged, bit-equal (pair and norms) to its scalar "
                  "distributed solve on the same ranks, within 2e-10/lambda_min of the "
                  "single-device solve_many member; one host read a step; the longest "
                  "member's exchanges; the members' bytes; batched launches only"})
    emit("solve_sparse_dist", {**k6h_rows, "solves": sparse_out,
                               "model_calibration": calibration,
                               "single_device": {k: {kk: vv for kk, vv in v.items() if kk != "x"}
                                                 for k, v in sparse_refs.items()
                                                 if isinstance(v, dict)}})
    return out, sparse_out, many_out


# solve_many_dist: the members of each case's batch (seeds 1 … K)
MANY_DIST = {"v_P2": 4, "pcg2_mesh2x2": 4, "diffusion_P2": 4, "v_P1_nccl_forced": 8,
             "ell_v_P2": 4, "ell_v_P1_nccl_forced": 4}


def single_many(solver, shape, K, dev):
    """The single-device ``solve_many`` on the card of seeds 1 … K
    (``main_rhs``): each member's merged iterate (float64 numpy) and
    cycles."""
    bt = torch.stack([main_rhs(shape, dev, sd) for sd in range(1, K + 1)])
    _, info = solver.solve_many(bt)
    torch.cuda.synchronize()
    if not all(info["converged"]):
        fail(f"solve_many_dist: the single-device solve_many of {shape} did not converge")
    return {"x": merged_pair(info), "cycles": info["cycles"]}


def many_dist_check(name, res, refs, bound, ell_bound):
    """A case of ``solve_many_dist`` (``many_in_rank``'s record): its
    faults, and every member within 2e-10/λ_min of the single-device
    ``solve_many`` member on the card (the single-device and the
    distributed cycles reach 1e-10 by other sums)."""
    if res["faults"]:
        fail(f"solve_many_dist {name}: {res['faults']}")
    kind = ("ell" if name.startswith("ell") else "pcg" if name.startswith("pcg")
            else "diffusion" if name.startswith("diffusion") else "v")
    ref = refs[kind]
    xs = np.load(res.pop("x_path"))
    lim = ell_bound if kind == "ell" else bound
    diffs = []
    for m in range(res["K"]):
        diffs.append(float(np.linalg.norm((xs[m] - ref["x"][m]).ravel())))
        if kind != "diffusion" and not diffs[-1] <= lim:
            fail(f"solve_many_dist {name} member {m}: ‖x_dist − x_single‖ = "
                 f"{diffs[-1]:.3e} > {lim:.3e}")
    res.update(norm_x_dist_minus_x_single=diffs, single_device_cycles=ref["cycles"][:res["K"]],
               bound_2e_10_over_lambda_min=None if kind == "diffusion" else lim)
    return res


def sparse_check(name, res, xd, refs, ell_bound):
    """A distributed sparse solve against the single-device one on the card:
    its cycles, ‖Δx‖₂ ≤ 2e-10/λ_min, the fine level partitioned, and K6h's
    launches (a V cycle of the ELL hierarchy with all four ELL levels
    partitioned launches K6h where the single-device cycle launches K6,
    and K6 never)."""
    launched = res["launches_rank0"]
    if name.startswith("irregular"):
        ref = refs["irregular"]
        bound = 2e-10 / ref["lambda_min_lower_bound"]
        per_cycle = None
    else:
        ref = refs["pcg" if "pcg" in name else "v"]
        bound = ell_bound
        per_cycle = refs["v"]["K6_per_cycle"]
        if "pcg" in name:  # krylov_iters cycles and as many A p a step
            per_cycle = INNER_KW["pcg"]["krylov_iters"] * (per_cycle + 1)
    diff = float(np.linalg.norm(xd - ref["x"]))
    res.update({"norm_x_dist_minus_x_single": diff, "bound_2e-10_over_lambda_min": bound,
                "single_device_cycles": ref["cycles"]})
    if res["cycles"] != ref["cycles"]:
        fail(f"solve_sparse_dist {name}: {res['cycles']} cycles, the single-device "
             f"solve {ref['cycles']}")
    if not diff <= bound:
        fail(f"solve_sparse_dist {name}: ‖x_dist − x_single‖ = {diff:.3e} > {bound:.3e}")
    if not res["partition_plan"][0] or launched.get("K6"):
        fail(f"solve_sparse_dist {name}: plan {res['partition_plan']}, launches {launched}")
    if per_cycle is not None:
        res["K6_halo_per_cycle"] = launched.get("K6_halo", 0) / res["cycles"]
        if not all(res["partition_plan"][:-1]) or res["K6_halo_per_cycle"] != per_cycle:
            fail(f"solve_sparse_dist {name}: {launched} in {res['cycles']} cycles, "
                 f"expected {per_cycle} K6h a cycle with every ELL level partitioned")


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--dist-rank":
        dist_rank(sys.argv[2:])
        return
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        sys.exit(2)
    import openmg_tpu_torch  # noqa: F401  (fails here when run without the package)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi, copy_bw = phase_env(dev)
    phase_build()
    rows, k2_rows, _ = phase_kernels(dev, copy_bw)
    k1b_rows, k2b_rows, k5b_rows = phase_batch_kernels(dev, copy_bw)
    k1_launches, k2_launches, faced_cycles, faced_rn64 = phase_solve(dev)
    phase_solve_512(dev)
    k5_rows, _ = phase_fused2d(dev, copy_bw)
    k5_counts = phase_solve_2d(dev)
    pcg, many = phase_solve_cycles_pcg(dev)
    # the unfaced and the diffusion hierarchies are built after the Poisson
    # solve, whose peak memory would otherwise count them
    unfaced = setup_unfaced(dev)
    phase_solve_unfaced(dev, unfaced, faced_cycles, faced_rn64)
    paths = {"faced 256^3": phase_faced(dev, unfaced, faced_cycles),
             "1D baseline config 1": phase_solve_1d(dev)}
    vary = setup_vary(dev)
    sweeps, h_big = phase_sweeps(dev, copy_bw, vary[0].hierarchy,
                                 unfaced[0].hierarchy)
    k34b_rows = phase_batch_sweeps(dev, copy_bw, h_big, vary[0].hierarchy)
    many_stack = phase_solve_many_stack(dev, vary, unfaced, h_big)
    del unfaced, h_big
    vary_counts, f32_counts = phase_solve_vary(dev, vary)
    phase_solve_pcg(dev, pcg, vary)
    paths.update({f"chebyshev {k}": v
                  for k, v in phase_solve_cheb(dev, vary).items()})
    paths.update({f"device-built {k}": v
                  for k, v in phase_setup_device(dev, vary).items()})
    halo_rows = phase_halo_kernels(dev, copy_bw, vary[0].hierarchy)
    del vary
    torch.cuda.empty_cache()
    solvers = setup_sparse_solvers(dev)
    spmv_rows = phase_spmv(dev, copy_bw, solvers)
    k67b_rows = phase_batch_spmv(dev, copy_bw, solvers)
    k7_launches, k6_launches = phase_solve_sparse(dev, solvers)
    many_sparse = phase_solve_many_sparse(dev, solvers)
    k6h_rows, k6hb_rows = phase_k6h(dev, copy_bw, solvers["ell"].hierarchy)
    sparse_refs = sparse_dist_refs(dev, solvers)
    del solvers
    torch.cuda.empty_cache()
    dist_runs, sparse_dist_runs, many_dist = phase_solve_dist(
        dev, copy_bw, sparse_refs, {"k6h": k6h_rows, "k6hb": k6hb_rows})
    del sparse_refs

    def entry(name, source, replaces, launches, main_row, all_rows, key):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms"),
            "shape": main_row["shape"],
            "mode": main_row.get("mode", "emit_norm"),
            "bound_ms_copy_bw": main_row["bound_ms_copy_bw"],
            # the ninth slice's paths, each counted from 0 around its solve
            "launches_by_path": {path: c[key] for path, c in paths.items()
                                 if c.get(key)},
        }

    k1_main = next(r for r in rows if r["level"] == "main"
                   and r["mode"].startswith("down"))
    k2_main = next(r for r in k2_rows if r["level"] == "main" and r["emit_norm"])
    # K3 on its solve's path is the 256³ constant residual; K4 on the
    # diffusion solve's path is the legs, the 256³ down-leg the largest
    k3_main = next(r for r in sweeps["K3"] if r["level"] == "main 256^3"
                   and r["mode"] == "residual")
    k4_main = next(r for r in sweeps["K4_legs"] if r["level"] == "main 256^3"
                   and r["mode"].startswith("down"))
    k5_main = next(r for r in k5_rows if r["level"] == "main 4096^2"
                   and r["mode"].startswith("down: zero start, 4 rb"))
    # the batched forms: the down-leg at full width, K = 8; launches in the
    # K = 8 solve_many at 256³ (K1b, K2b) and at 4096² (K5b)
    k1b_main, k5b_main = (
        next(r for r in rs if r["mode"].startswith("down: zero start"))
        for rs in (k1b_rows, k5b_rows))
    # K3b: the 256³ residual (the float32 outer residual's and Chebyshev's
    # launch); K4b: the 256³ diffusion down-leg; K6b, K7b: level 0 of the
    # 1024² ELL and 64³ BSR hierarchies; launches in the K = 8 Chebyshev
    # and diffusion solve_many, and the K = 4 sparse ones
    k3b_main = next(r for r in k34b_rows["K3b"] if r["level"] == f"{BIG[0]}^3"
                    and r["mode"] == "residual")
    k4b_main = next(r for r in k34b_rows["K4b"] if r["level"] == f"{BIG[0]}^3"
                    and r["mode"].startswith("down"))
    print(json.dumps({"kernels": [
        entry("fused_stages_const_3d",
              "openmg_tpu_torch/csrc/fused_stages.cu",
              "openmg_tpu/ops/fused.py:578", k1_launches, k1_main, rows, "K1"),
        entry("df_update_residual_const_3d",
              "openmg_tpu_torch/csrc/df_update.cu",
              "openmg_tpu/ops/kernels.py:860", k2_launches, k2_main, k2_rows, "K2"),
        entry("half_sweep (constant / cornered taps)",
              "openmg_tpu_torch/csrc/half_sweep.cu",
              "openmg_tpu/ops/kernels.py:344", f32_counts["K3"], k3_main,
              sweeps["K3"], "K3"),
        entry("sweeps_vary_3d (per-point coefficients, a leg a launch)",
              "openmg_tpu_torch/csrc/vary_leg.cu",
              "openmg_tpu/ops/kernels.py:612", vary_counts["K4"], k4_main,
              sweeps["K4"] + sweeps["K4_legs"], "K4"),
        entry("fused_stages_2d",
              "openmg_tpu_torch/csrc/fused_stages_2d.cu",
              "openmg_tpu/ops/kernels.py:1134", k5_counts["K5"], k5_main,
              k5_rows, "K5"),
        entry("fused_stages_const_3d_batch (K1b: K members a launch)",
              "openmg_tpu_torch/csrc/fused_stages.cu",
              "openmg_tpu/ops/fused.py:578",
              many["256^3"]["launches"]["K1b"], k1b_main, k1b_rows, "K1b"),
        entry("df_update_residual_batch (K2b: K members a launch)",
              "openmg_tpu_torch/csrc/df_update.cu",
              "openmg_tpu/ops/kernels.py:860",
              many["256^3"]["launches"]["K2b"], k2b_rows[0], k2b_rows, "K2b"),
        entry("fused_stages_2d_batch (K5b: K members a launch)",
              "openmg_tpu_torch/csrc/fused_stages_2d.cu",
              "openmg_tpu/ops/kernels.py:1134",
              many["4096^2"]["launches"]["K5b"], k5b_main, k5b_rows, "K5b"),
        entry("half_sweep_batch (K3b: K members a launch)",
              "openmg_tpu_torch/csrc/half_sweep.cu",
              "openmg_tpu/ops/kernels.py:344",
              many_stack["256^3 Poisson chebyshev"]["launches"]["K3b"], k3b_main,
              k34b_rows["K3b"], "K3b"),
        entry("sweeps_vary_batch (K4b: K members a leg)",
              "openmg_tpu_torch/csrc/vary_leg.cu",
              "openmg_tpu/ops/kernels.py:612",
              many_stack["256^3 diffusion"]["launches"]["K4b"], k4b_main,
              k34b_rows["K4b"], "K4b"),
        entry("spmv_ell_batch (K6b: K vectors a launch)",
              "openmg_tpu_torch/csrc/spmv_banded.cu",
              "openmg_tpu/ops/ell.py:169", many_sparse["ell"]["launches"]["K6b"],
              k67b_rows["K6b"][0], k67b_rows["K6b"], "K6b"),
        entry("spmv_bsr_batch (K7b: K vectors a launch)",
              "openmg_tpu_torch/csrc/spmv_banded.cu",
              "openmg_tpu/ops/bsr.py:114", many_sparse["bsr"]["launches"]["K7b"],
              k67b_rows["K7b"][0], k67b_rows["K7b"], "K7b"),
        entry("spmv_ell (slot-offset ELL SpMV, spmv_banded at B=1)",
              "openmg_tpu_torch/csrc/spmv_banded.cu",
              "openmg_tpu/ops/ell.py:169", k6_launches, spmv_rows["K6"][0],
              spmv_rows["K6"], "K6"),
        entry("spmv_bsr (blocked-band BSR SpMV, spmv_banded)",
              "openmg_tpu_torch/csrc/spmv_banded.cu",
              "openmg_tpu/ops/bsr.py:114", k7_launches, spmv_rows["K7"][0],
              spmv_rows["K7"], "K7"),
        # the halo forms: times of one inner slab of 256³ / 4 (halo_kernels),
        # launches on rank 0 of the two-rank 256³ solve (the diffusion one
        # for K4's)
        entry("fused_stages_const_3d (halos=, a rank's slab)",
              "openmg_tpu_torch/csrc/fused_stages.cu",
              "openmg_tpu/ops/fused.py:578",
              dist_runs["v_P2"]["launches_rank0"]["K1_halo"],
              halo_rows["K1"][0], halo_rows["K1"], "K1_halo"),
        entry("df_update_residual_const_3d (halos=, a rank's slab)",
              "openmg_tpu_torch/csrc/df_update.cu",
              "openmg_tpu/ops/kernels.py:860",
              dist_runs["v_P2"]["launches_rank0"]["K2_halo"],
              halo_rows["K2"][0], halo_rows["K2"], "K2_halo"),
        entry("halo_half_sweep_const_3d (K3's halo form)",
              "openmg_tpu_torch/csrc/half_sweep.cu",
              "openmg_tpu/ops/kernels.py:502",
              dist_runs["v_P2"]["launches_rank0"]["K3_halo"],
              next(r for r in halo_rows["K3"] if r["mode"] == "residual"),
              halo_rows["K3"], "K3_halo"),
        entry("halo_half_sweep_vary_3d (K4's halo form)",
              "openmg_tpu_torch/csrc/half_sweep.cu",
              "openmg_tpu/ops/kernels.py:678",
              dist_runs["diffusion_P2"]["launches_rank0"]["K4_halo"],
              next(r for r in halo_rows["K4"] if r["mode"] == "residual"),
              halo_rows["K4"], "K4_halo"),
        # K6's halo form: an inner row block of the 1024² ELL level 0 cut in
        # 4; launches on rank 0 of the two-rank ELL solve. It replaces the
        # JAX package's shifted slices outside any Pallas kernel
        entry("spmv_banded_halo (K6's halo form, a rank's rows)",
              "openmg_tpu_torch/csrc/spmv_banded.cu",
              "openmg_tpu/parallel/sparse_dist.py:167",
              sparse_dist_runs["ell_v_P2"]["launches_rank0"]["K6_halo"],
              k6h_rows[0], k6h_rows, "K6_halo"),
        # the halo forms on a batch: K = 8 on an inner slab of 256³ / 4 (the
        # 1024² ELL level 0's inner block for K6hb); launches on rank 0 of
        # the two-rank K = 4 solve_many (the diffusion one for K4hb's)
        entry("fused_stages_const_3d_batch (halos=, K1hb: K members of a slab)",
              "openmg_tpu_torch/csrc/fused_stages.cu",
              "openmg_tpu/ops/fused.py:578",
              many_dist["v_P2"]["launches_rank0"]["K1hb"],
              halo_rows["K1hb"][0], halo_rows["K1hb"], "K1hb"),
        entry("df_update_residual_batch (halos=, K2hb: K members of a slab)",
              "openmg_tpu_torch/csrc/df_update.cu",
              "openmg_tpu/ops/kernels.py:860",
              many_dist["v_P2"]["launches_rank0"]["K2hb"],
              halo_rows["K2hb"][0], halo_rows["K2hb"], "K2hb"),
        entry("halo_half_sweep_batch (K3hb: K members of a slab)",
              "openmg_tpu_torch/csrc/half_sweep.cu",
              "openmg_tpu/ops/kernels.py:502",
              many_dist["v_P2"]["launches_rank0"]["K3hb"],
              next(r for r in halo_rows["K3hb"] if r["mode"] == "residual"),
              halo_rows["K3hb"], "K3hb"),
        entry("halo_half_sweep_vary_batch (K4hb: K members of a slab)",
              "openmg_tpu_torch/csrc/half_sweep.cu",
              "openmg_tpu/ops/kernels.py:678",
              many_dist["diffusion_P2"]["launches_rank0"]["K4hb"],
              next(r for r in halo_rows["K4hb"] if r["mode"] == "residual"),
              halo_rows["K4hb"], "K4hb"),
        entry("spmv_banded_halo_batch (K6hb: K members of a rank's rows)",
              "openmg_tpu_torch/csrc/spmv_banded.cu",
              "openmg_tpu/parallel/sparse_dist.py:167",
              many_dist["ell_v_P2"]["launches_rank0"]["K6hb"],
              k6hb_rows[0], k6hb_rows, "K6hb"),
    ]}), flush=True)
    emit("total", {"seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
