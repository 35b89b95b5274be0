"""Per-pass stencil kernels and the double-float outer step (twin of
``openmg_tpu/ops/kernels.py``).

**One pass of a radius-1 stencil** (K3, K4: the JAX module's ``_half_sweep``
and ``_half_sweep_vary``), in three modes:

    jacobi    x + ω·D⁻¹(b − A x)
    residual  b − A x
    rbgs      D⁻¹(b − (A − D) x) on the points of one colour, x elsewhere

for a constant operator (a ``(K,)`` vector of taps; with ``corner=`` a
cornered one), or for per-point coefficient grids ``(K, nz, ny, nx)``.  The
entry points keep the JAX package's names and argument order
(``residual_const_3d``, ``jacobi_const_3d``, ``rbgs_const_3d``,
``rbgs_half_sweep_const_3d`` and their ``_vary_3d`` twins) and lift a 2D
operand, cornered ones included, to ``(1, ny, nx)`` and a 1D one to
``(1, 1, n)``.

**One leg of a varying-level visit** (K4 again, one launch for all the
passes of the JAX module's ``rbgs_vary_3d`` / ``jacobi_vary_3d`` and the
``residual_vary_3d`` after them): :func:`sweeps_vary_3d` runs ``passes``
Jacobi or red/black passes from zero or from a given ``x``, and with
``emit_residual`` the residual of the last iterate, in launches of
``csrc/vary_leg.cu`` of up to :func:`leg_depth` passes each (a launch of
one level is a pass of ``csrc/half_sweep.cu``); its plain
version :func:`sweeps_vary_plain` is the loop of
:func:`half_sweep_vary_plain` passes.

**The whole-visit 2D stage fusion** (K5, the JAX module's
``fused_stages_2d``): every stage of a level visit on a 2D plane, with the
optional zero start, prolongation on load, residual and restriction, in one
launch of ``csrc/fused_stages_2d.cu``.

**The double-float outer step** (K2), one pass per outer cycle of the
defect-correction loop (a 2D grid lifted to ``(1, ny, nx)``):

    (x_hi', x_lo') = df_add_f32((x_hi, x_lo), e)
    r_hi           = hi(b − A x')      in double-float

for a constant radius-1 3D stencil whose taps are sums of signed powers of
two (``terms[k] = pow2_terms(values[k])``): every product is exact in
float32, only compensated adds remain.  With ``emit_norm`` the call also
returns partial sums of ``r_hi²`` whose total is ‖r_hi‖²; their number and
layout belong to the implementation (the caller sums them).

Every entry point dispatches on the device of its grid tensor alone: a CUDA
tensor launches the hand-written kernel (``csrc/half_sweep.cu``,
``csrc/df_update.cu``, ``csrc/fused_stages_2d.cu``) or raises; a CPU tensor
runs the plain version (:func:`half_sweep_plain`,
:func:`half_sweep_vary_plain`, :func:`df_update_residual_const_3d_plain`,
:func:`fused_stages_2d_plain`), which applies the same float32 operations in
the same order.  K2's three arrays agree with the kernel bit for bit;
K3/K4/K5 within a few ulp (the compiler contracts multiply-adds).
``LAUNCHES`` (K2), ``LAUNCHES_K3``, ``LAUNCHES_K4`` and ``LAUNCHES_K5``
count launched kernels: one per pass for K3 and the per-pass K4, one per
leg (or chunk of one) for :func:`sweeps_vary_3d`, one per visit for K5.

**The batched forms** (the JAX module's kernels under ``jax.vmap``, whose
grids gain a leading batch axis): :func:`df_update_residual_batch` (K2b),
:func:`half_sweep_batch` (K3b), :func:`half_sweep_vary_batch` and
:func:`sweeps_vary_batch` (K4b: a pass, a leg) and
:func:`fused_stages_2d_batch` (K5b) take K members of one grid stacked
along a leading axis, the operator shared, and run them in one launch
(a leg: in the scalar leg's launches); each member's outputs equal the
scalar launch's on it bit for bit.  Their plain versions (the same names
with ``_plain``) are the scalar plain versions member by member.  They
count apart: ``LAUNCHES_K2_BATCH``, ``LAUNCHES_K3_BATCH``,
``LAUNCHES_K4_BATCH``, ``LAUNCHES_K5_BATCH``.  K2b's partials are ``(K,
P)``, a row a member laid out as the scalar launch's; :func:`df_norms`
reduces each row with the scalar path's own call.

**The halo forms** (the row-partitioned tier,
:mod:`openmg_tpu_torch.parallel.fast`): :func:`halo_half_sweep_const_3d`
(K3), :func:`halo_half_sweep_vary_3d` (K4) and
``df_update_residual_const_3d(..., halos=...)`` (K2) run on a rank's
z-slab with the planes received from the ranks below and above, which the
kernel reads in place of the Dirichlet zero at the slab's first and last
plane (no boundary epilogue, no concatenated slab).  Their plain versions
concatenate the planes and slice the result.  They count apart:
``LAUNCHES_K3_HALO``, ``LAUNCHES_K4_HALO``, ``LAUNCHES_K2_HALO``.

**The halo forms on a batch** (the halo kernels under ``jax.vmap``):
:func:`halo_half_sweep_batch` (K3hb), :func:`halo_half_sweep_vary_batch`
(K4hb, a pass a launch as K4h) and ``df_update_residual_batch(...,
halos=...)`` (K2hb) run K members of a rank's slab in one launch, every
member with its own received planes (``(K, 1, *plane)``) and the operator
shared; each member equals the scalar halo launch on it bit for bit.  Their
plain versions are the scalar halo forms member by member.  They count
apart: ``LAUNCHES_K3_HALO_BATCH``, ``LAUNCHES_K4_HALO_BATCH``,
``LAUNCHES_K2_HALO_BATCH``.

The JAX package's folded-2D tier is its own hardware's layout and is not
ported.
"""

from __future__ import annotations

import ctypes

import torch

from openmg_tpu_torch.ops.doublefloat import df_add_f32, two_sum
from openmg_tpu_torch.ops.fused import (
    _batch_operands, _norm_stages, _visit_ok, depth_chunks,
)
from openmg_tpu_torch.ops.stencil import diag_index, kernel_taps_ok, shift

__all__ = [
    "LAUNCHES",
    "LAUNCHES_K3",
    "LAUNCHES_K4",
    "LAUNCHES_K5",
    "LAUNCHES_K2_HALO",
    "LAUNCHES_K3_HALO",
    "LAUNCHES_K4_HALO",
    "LAUNCHES_K2_BATCH",
    "LAUNCHES_K3_BATCH",
    "LAUNCHES_K4_BATCH",
    "LAUNCHES_K5_BATCH",
    "LAUNCHES_K2_HALO_BATCH",
    "LAUNCHES_K3_HALO_BATCH",
    "LAUNCHES_K4_HALO_BATCH",
    "halo_half_sweep_batch",
    "halo_half_sweep_batch_plain",
    "halo_half_sweep_vary_batch",
    "halo_half_sweep_vary_batch_plain",
    "half_sweep_batch",
    "half_sweep_batch_plain",
    "half_sweep_vary_batch",
    "half_sweep_vary_batch_plain",
    "sweeps_vary_batch",
    "sweeps_vary_batch_plain",
    "df_norms",
    "df_update_residual_batch",
    "df_update_residual_batch_plain",
    "fused_stages_2d_batch",
    "fused_stages_2d_batch_plain",
    "halo_half_sweep_const_3d",
    "halo_half_sweep_vary_3d",
    "MAX_DEPTH_2D",
    "fused2d_plan",
    "df_num_partials",
    "df_update_residual_const_3d",
    "df_update_residual_const_3d_plain",
    "half_sweep_plain",
    "half_sweep_vary_plain",
    "sweep_plan",
    "LEG_DEPTH",
    "leg_depth",
    "leg_chunks",
    "sweeps_vary_plain",
    "sweeps_vary_3d",
    "residual_const_3d",
    "jacobi_const_3d",
    "rbgs_const_3d",
    "rbgs_half_sweep_const_3d",
    "residual_vary_3d",
    "jacobi_vary_3d",
    "rbgs_vary_3d",
    "rbgs_half_sweep_vary_3d",
    "fused_stages_2d",
    "fused_stages_2d_plain",
]

# calls of df_update_residual_const_3d that launched the CUDA kernel
LAUNCHES = 0
# passes that launched the half-sweep kernel: constant / cornered taps (K3)
LAUNCHES_K3 = 0
# ... and per-point coefficient grids (K4)
LAUNCHES_K4 = 0
# launches of the whole-visit 2D stage fusion (K5)
LAUNCHES_K5 = 0
# launches of the halo forms (a rank's slab with received planes): K2, K3, K4
LAUNCHES_K2_HALO = 0
LAUNCHES_K3_HALO = 0
LAUNCHES_K4_HALO = 0
# launches of the batched forms (K members of one grid a launch): K2, K3,
# K4 (single passes and legs), K5
LAUNCHES_K2_BATCH = 0
LAUNCHES_K3_BATCH = 0
LAUNCHES_K4_BATCH = 0
LAUNCHES_K5_BATCH = 0
# launches of the halo forms on a batch (K members of a rank's slab a
# launch): K2, K3, K4
LAUNCHES_K2_HALO_BATCH = 0
LAUNCHES_K3_HALO_BATCH = 0
LAUNCHES_K4_HALO_BATCH = 0


def df_update_residual_const_3d_plain(
    offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm: bool = False,
    halos=None,
):
    """Plain PyTorch version of :func:`df_update_residual_const_3d`, in the
    kernel's order of operations: update every point, then for each offset
    and each of its power-of-two terms ``p`` one compensated
    ``acc ← acc − p·x'[i + off]`` (neighbours outside the domain are zero).
    With ``emit_norm`` the partials are one sum of ``r_hi²`` per slice of
    the first axis (a z-plane, or a row of a 2D grid).  ``halos``: the
    received ``(lower, upper)`` planes of ``x_hi``, ``x_lo`` and ``e``,
    updated and read as the neighbours across the slab's z edges."""
    offsets = tuple(tuple(o) for o in offsets)
    if halos is not None:
        x_hi, x_lo, e = (
            torch.cat([lo, t, hi], dim=0)
            for t, (lo, hi) in zip((x_hi, x_lo, e), halos)
        )
        zero = torch.zeros_like(b_hi[:1])
        b_hi = torch.cat([zero, b_hi, zero], dim=0)
        b_lo = torch.cat([zero, b_lo, zero], dim=0)
        out = df_update_residual_const_3d_plain(
            offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm
        )
        return tuple(a[1:-1] for a in out)
    nxh, nxl = df_add_f32((x_hi, x_lo), e)
    acch, accl = b_hi, b_lo
    for off, tp in zip(offsets, terms):
        sh_h = shift(nxh, off)
        sh_l = shift(nxl, off)
        for p in tp:
            th, tl = -float(p) * sh_h, -float(p) * sh_l
            s, err = two_sum(acch, th)
            err = err + (accl + tl)
            acch = s + err
            accl = err - (acch - s)
    if emit_norm:
        planes = tuple(range(1, acch.ndim))
        return nxh, nxl, acch, torch.sum(acch * acch, dim=planes)
    return nxh, nxl, acch


# K2's tiling (csrc/df_update.cu): a block owns DF_TILE = (16, 32) points of
# (y, x) and a chunk of z; the launch aims at DF_TARGET_BLOCKS blocks
DF_TILE = (16, 32)
DF_TARGET_BLOCKS = 1024


def df_num_partials(nz: int, ny: int, nx: int) -> int:
    """Partial sums of ``r_hi²`` K2 writes for a grid of this shape: one a
    block, the blocks of its tiling (the kernel's
    ``omg_df_num_partials``, which the wrapper holds this against)."""
    ty, tx = DF_TILE
    tiles = -(-nx // tx) * -(-ny // ty)
    chunks = min(nz, max(1, -(-DF_TARGET_BLOCKS // tiles)))
    zc = -(-nz // chunks)
    return tiles * -(-nz // zc)


_fns = None


def _kernel():
    global _fns
    if _fns is None:
        from openmg_tpu_torch import _build

        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.omg_df_update_residual
        fn.argtypes = [p, p, p, i] + [p] * 9 + [p] * 6 + [i, i, i, i, i, p]
        fn.restype = i
        npart = lib.omg_df_num_partials
        npart.argtypes = [i, i, i]
        npart.restype = i
        _fns = (fn, npart)
    return _fns


def _df_update_residual_cuda(offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm,
                             halos=None, batch=False):
    """One launch of ``csrc/df_update.cu``: a 3D grid, or with ``batch`` a
    ``(K, nz, ny, nx)`` stack of them (partials ``(K, P)``; with ``halos``
    each member's planes ``(K, 1, ny, nx)``)."""
    global LAUNCHES, LAUNCHES_K2_HALO, LAUNCHES_K2_BATCH, LAUNCHES_K2_HALO_BATCH
    dev = x_hi.device
    if x_hi.ndim != 3 + int(batch):
        what = "(K, nz, ny, nx) batches" if batch else "3D grids"
        raise ValueError(f"the kernel takes {what}, got shape {tuple(x_hi.shape)}")
    shape = tuple(x_hi.shape)
    if batch and shape[0] < 1:
        raise ValueError("a batch of at least one member")
    for name, t in (("x_hi", x_hi), ("x_lo", x_lo), ("e", e),
                    ("b_hi", b_hi), ("b_lo", b_lo)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    planes = [None] * 6
    if halos is not None:
        from openmg_tpu_torch.ops.fused import _check

        # x_hi, x_lo, e: lower then upper; each one (1, ny, nx) plane (a
        # member's, on a batch)
        for j, (name, pair) in enumerate(zip(("x_hi", "x_lo", "e"), halos)):
            for side, t in enumerate(pair):
                _check(f"{name} halo", t, shape[:-3] + (1,) + shape[-2:], dev)
                planes[3 * side + j] = t.data_ptr()
    K = len(offsets)
    if K > 27 or any(abs(o) > 1 for off in offsets for o in off):
        raise ValueError("the kernel takes radius-1 stencils of at most 27 taps")
    if len(terms) != K or any(t is None or len(t) > 3 for t in terms):
        raise ValueError("every tap needs at most 3 power-of-two terms")

    fn, npart = _kernel()
    nz, ny, nx = shape[-3:]
    nb = shape[0] if batch else 1
    oxh = torch.empty_like(x_hi)
    oxl = torch.empty_like(x_hi)
    orh = torch.empty_like(x_hi)
    partials, pstride = None, 0
    if emit_norm:
        n_part = npart(nz, ny, nx)
        if n_part != df_num_partials(nz, ny, nx):
            raise RuntimeError(
                f"csrc/df_update.cu writes {n_part} partials for {shape}, "
                f"the wrapper expects {df_num_partials(nz, ny, nx)}"
            )
        # a member's row starts 128-byte aligned, as a fresh (P,) tensor
        # does, so each row's sum takes the scalar path's reduction
        pstride = -(-n_part // 32) * 32 if batch else n_part
        rows = torch.empty((nb, pstride), dtype=torch.float32, device=dev)
        partials = rows[:, :n_part] if batch else rows[0]
    offs_c = (ctypes.c_int * (3 * K))(*[o for off in offsets for o in off])
    nterms_c = (ctypes.c_int * K)(*[len(t) for t in terms])
    flat = []
    for t in terms:
        flat += [float(p) for p in t] + [0.0] * (3 - len(t))
    terms_c = (ctypes.c_float * (3 * K))(*flat)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            offs_c, nterms_c, terms_c, K,
            x_hi.data_ptr(), x_lo.data_ptr(), e.data_ptr(),
            b_hi.data_ptr(), b_lo.data_ptr(),
            oxh.data_ptr(), oxl.data_ptr(), orh.data_ptr(),
            None if partials is None else partials.data_ptr(),
            *planes, nz, ny, nx, nb, pstride, stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_df_update_residual failed with code {rc}")
    if batch and halos is not None:
        LAUNCHES_K2_HALO_BATCH += 1
    elif batch:
        LAUNCHES_K2_BATCH += 1
    elif halos is None:
        LAUNCHES += 1
    else:
        LAUNCHES_K2_HALO += 1
    if emit_norm:
        return oxh, oxl, orh, partials
    return oxh, oxl, orh


def df_update_residual_const_3d(
    offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm: bool = False,
    halos=None,
):
    """Outer-loop step for dyadic constant 3D stencils; returns
    ``(x_hi', x_lo', r_hi)`` and, with ``emit_norm``, a 1-D tensor of
    partial sums whose total is ‖r_hi‖².  A 2D grid runs lifted to
    ``(1, ny, nx)`` with offsets ``(0, oy, ox)``, a 1D grid to ``(1, 1, n)``
    with offsets ``(0, 0, o)``, on either device.

    ``halos`` (a rank's z-slab): ``((xh_lo, xh_hi), (xl_lo, xl_hi), (e_lo,
    e_hi))``, the planes of ``x_hi``, ``x_lo`` and ``e`` received from the
    ranks below and above (zeros at the domain edges), each ``(1, ny,
    nx)``.  The kernel updates them as it does its own planes and reads
    them as the neighbours across the slab's edges; no edge repair
    follows.  A 2D or 1D grid refuses halos: its lift puts the partition
    axis on the kernel's y axis, as in the JAX package.

    ``offsets`` / ``terms`` are static host tuples.  Inputs are never
    modified.  On a CUDA tensor the kernel is enqueued on the current
    stream and the call does not wait for it.
    """
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    terms = tuple(tuple(t) for t in terms)
    if x_hi.ndim in (1, 2):
        if halos is not None:
            raise ValueError(
                "halos on a 2D or 1D grid: the lift maps the partition axis "
                "to the kernel's y axis (partitioned 2D slabs take the "
                "tensor double-float residual)"
            )
        out = df_update_residual_const_3d(
            _lift(offsets), terms, *map(_up, (x_hi, x_lo, e, b_hi, b_lo)),
            emit_norm=emit_norm,
        )
        return tuple(a.reshape(x_hi.shape) for a in out[:3]) + tuple(out[3:])
    if x_hi.device.type == "cpu":
        return df_update_residual_const_3d_plain(
            offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm, halos
        )
    if x_hi.device.type != "cuda":
        raise ValueError(f"unsupported device {x_hi.device}")
    return _df_update_residual_cuda(
        offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm, halos
    )


def _df_batch_halos(nd, halos, K):
    """Raise unless ``halos`` are K2hb's: a 3D batch's ``(K, 1, ny, nx)``
    planes (a 2D or 1D grid refuses halos, as the scalar form)."""
    if halos is None:
        return
    if nd != 3:
        raise ValueError(
            "halos on a 2D or 1D grid: the lift maps the partition axis to "
            "the kernel's y axis (partitioned 2D slabs take the tensor "
            "double-float residual)"
        )
    for pair in halos:
        if any(t.ndim != 4 or t.shape[0] != K for t in pair):
            raise ValueError(
                f"K2hb: halo planes of shapes {[tuple(t.shape) for t in pair]} "
                f"for {K} members; each (K, 1, ny, nx)"
            )


def df_update_residual_batch_plain(offsets, terms, x_hi, x_lo, e, b_hi, b_lo,
                                   emit_norm: bool = False, halos=None):
    """Plain version of :func:`df_update_residual_batch`: the scalar plain
    version on each member (on its 3D lift; with ``halos``, on its planes),
    stacked; partials ``(K, nz)``."""
    nd = _batch_operands(offsets, (x_hi, x_lo, e, b_hi, b_lo), "K2b")
    _df_batch_halos(nd, halos, x_hi.shape[0])
    offs3 = _lift(offsets) if nd < 3 else offsets
    outs = [
        df_update_residual_const_3d_plain(
            offs3, terms, *(_up(t[m]) for t in (x_hi, x_lo, e, b_hi, b_lo)),
            emit_norm=emit_norm,
            halos=None if halos is None else tuple((lo[m], hi[m]) for lo, hi in halos),
        )
        for m in range(x_hi.shape[0])
    ]
    stacked = [torch.stack([o[j] for o in outs]) for j in range(len(outs[0]))]
    return tuple(a.reshape(x_hi.shape) for a in stacked[:3]) + tuple(stacked[3:])


def df_update_residual_batch(offsets, terms, x_hi, x_lo, e, b_hi, b_lo,
                             emit_norm: bool = False, halos=None):
    """K2b: :func:`df_update_residual_const_3d` on K right-hand sides of
    one grid at once, every operand ``(K, *grid)`` (a grid of 1, 2 or 3
    dimensions, by the offsets).  Returns ``(x_hi', x_lo', r_hi)`` stacked
    and, with ``emit_norm``, partials ``(K, P)`` whose row k sums to member
    k's ‖r_hi‖² (:func:`df_norms`).  On a CUDA tensor one launch for the
    batch, each member bit-equal to the scalar launch; on a CPU tensor the
    plain version.

    ``halos`` (K2hb: K members of a rank's 3D slab): as the scalar halo
    form's, each plane a stack of the members' ``(K, 1, ny, nx)``."""
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    terms = tuple(tuple(t) for t in terms)
    nd = _batch_operands(offsets, (x_hi, x_lo, e, b_hi, b_lo), "K2b")
    _df_batch_halos(nd, halos, x_hi.shape[0])
    if x_hi.device.type == "cpu":
        return df_update_residual_batch_plain(
            offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm, halos
        )
    if x_hi.device.type != "cuda":
        raise ValueError(f"unsupported device {x_hi.device}")
    K = x_hi.shape[0]
    lift = (K,) + (1,) * (3 - nd) + tuple(x_hi.shape[1:])
    out = _df_update_residual_cuda(
        _lift(offsets) if nd < 3 else offsets, terms,
        *(t.reshape(lift) for t in (x_hi, x_lo, e, b_hi, b_lo)),
        emit_norm, halos, batch=True,
    )
    return tuple(a.reshape(x_hi.shape) for a in out[:3]) + tuple(out[3:])


def df_norms(partials):
    """Each member's ‖r_hi‖₂ from K2b's ``(K, P)`` partials, a ``(K,)``
    tensor: every row summed by the call the scalar step makes on its
    ``(P,)`` partials (``torch.sum``), so a member's norm has the bits of
    its scalar solve's (one reduction over the batch need not add in that
    order)."""
    return torch.sqrt(torch.stack([torch.sum(row) for row in partials]))


# ---------------------------------------------------------------------------
# one pass of a radius-1 stencil (K3 constant / cornered, K4 varying)
# ---------------------------------------------------------------------------

_MODE_CODE = {"jacobi": 0, "rbgs": 1, "residual": 2}


def _lift2d(offsets):
    return tuple((0,) + tuple(o) for o in offsets)


def _lift1d(offsets):
    return tuple((0, 0) + tuple(o) for o in offsets)


def _lift(offsets):
    """Offsets of a 1D or 2D operator on its lift to 3D."""
    return _lift1d(offsets) if len(offsets[0]) == 1 else _lift2d(offsets)


def _up(t):
    """A 1D or 2D grid tensor as its lift ``(1, 1, n)`` / ``(1, ny, nx)``
    (a view; None passes through)."""
    if t is None:
        return None
    return t.reshape((1,) * (3 - t.ndim) + tuple(t.shape))


def _norm_offsets(offsets):
    return tuple(tuple(int(o) for o in off) for off in offsets)


def _pass_plain(fields, offsets, b, x, mode, omega, color, inv_d, region, z0=0):
    """One pass in the kernel's order: the taps summed in the order of
    ``offsets`` (the diagonal skipped in a red/black pass), then
    ``inv_d · (b − sum)``; the points of ``region`` (a boolean grid, or
    None) divide by their own diagonal instead.  ``z0``: the z index of
    the first plane (a red/black colour is the parity of the local
    index)."""
    if mode not in _MODE_CODE:
        raise ValueError(f"unknown mode {mode!r}; choose jacobi|rbgs|residual")
    di = diag_index(offsets)
    acc = None
    for k, off in enumerate(offsets):
        if mode == "rbgs" and k == di:
            continue
        term = fields[k] * shift(x, off)
        acc = term if acc is None else acc + term
    if acc is None:  # diagonal-only operator, diagonal skipped
        acc = torch.zeros_like(x)
    res = b - acc
    if mode == "residual":
        return res
    if mode == "jacobi":
        out = x + omega * (inv_d * res)
        if region is not None:
            out = torch.where(region, x + (omega * res) / fields[di], out)
        return out
    xn = inv_d * res
    if region is not None:
        xn = torch.where(region, res / fields[di], xn)
    nz, ny, nx = x.shape
    dev = x.device
    par = (
        torch.arange(z0, z0 + nz, device=dev).view(-1, 1, 1)
        + torch.arange(ny, device=dev).view(1, -1, 1)
        + torch.arange(nx, device=dev).view(1, 1, -1)
    ) & 1
    return torch.where(par == int(color), xn, x)


def _ext_planes(t, halos):
    """``t`` with one plane on each side: the received planes ``halos``, or
    (``halos`` None) a copy of its edge planes, for grids whose values
    there are never used."""
    if halos is None:
        return torch.cat([t[:1], t, t[-1:]], dim=0)
    return torch.cat([halos[0], t, halos[1]], dim=0)


def _halo_pass_plain(fields, offsets, b, x, mode, omega, color, inv_d, region,
                     halos):
    """One pass on a slab with the received ``(lower, upper)`` planes: the
    pass on the slab extended by them, then its own planes."""
    grid = lambda t: t if t.ndim == 0 else _ext_planes(t, None)  # noqa: E731
    zero = torch.zeros_like(b[:1])
    out = _pass_plain(
        [grid(f) for f in fields], offsets, torch.cat([zero, b, zero], dim=0),
        _ext_planes(x, halos), mode, omega, color, grid(inv_d),
        None if region is None else grid(region), z0=-1,
    )
    return out[1:-1]


def half_sweep_plain(values, offsets, b, x, mode, omega=0.0, color=0, corner=None,
                     halos=None):
    """Plain PyTorch version of one constant-tap pass (3D operands).
    ``corner``: optional ``(regions, (n_regions, K) table)`` of a cornered
    operator; its low faces, edges and corner take their own tap rows.
    ``halos``: the received ``(lower, upper)`` planes of a rank's slab
    (:func:`halo_half_sweep_const_3d`)."""
    offsets = _norm_offsets(offsets)
    shape = tuple(x.shape)
    fields, region = [values[k] for k in range(len(offsets))], None
    if corner:
        regions, tbl = corner
        region = torch.zeros(shape, dtype=torch.bool, device=x.device)
        fields = [
            torch.zeros(shape, dtype=values.dtype, device=x.device) + values[k]
            for k in range(len(offsets))
        ]
        # ascending regions: the deepest region a point lies in wins
        for r, R in enumerate(regions):
            idx = tuple(slice(0, 1) if a in R else slice(None) for a in range(3))
            region[idx] = True
            for k in range(len(offsets)):
                fields[k][idx] = tbl[r, k]
    inv_d = 1.0 / values[diag_index(offsets)]
    if halos is not None:
        return _halo_pass_plain(fields, offsets, b, x, mode, omega, color, inv_d,
                                region, halos)
    return _pass_plain(fields, offsets, b, x, mode, omega, color, inv_d, region)


def half_sweep_vary_plain(coeffs, offsets, b, x, mode, omega=0.0, color=0,
                          halos=None):
    """Plain PyTorch version of one varying-coefficient pass (3D operands):
    ``coeffs`` is ``(K, nz, ny, nx)``, ``inv_d = 1 / coeffs[diag]`` per
    point.  ``halos``: as in :func:`half_sweep_plain`."""
    offsets = _norm_offsets(offsets)
    inv_d = 1.0 / coeffs[diag_index(offsets)]
    if halos is not None:
        return _halo_pass_plain(list(coeffs), offsets, b, x, mode, omega, color,
                                inv_d, None, halos)
    return _pass_plain(coeffs, offsets, b, x, mode, omega, color, inv_d, None)


# rows and columns of the tile a block of csrc/half_sweep.cu's constant pass
# owns (its CY, CX); the block marches a chunk of planes
K3_TILE = (8, 128)
# the fewest blocks a launch should have (per SM) before its chunks of
# planes get longer; chunks of 1 to 64 planes
K3_BLOCKS_PER_SM = 1
K3_PLANES = 64


def sweep_plan(nz: int, ny: int, nx: int, sms: int = 132):
    """How a launch of ``csrc/half_sweep.cu``'s constant pass covers an
    (nz, ny, nx) grid: ``(zc, tiles_y, tiles_x, chunks)``.  A block owns a
    tile of ``K3_TILE`` (rows, columns) of every plane of a chunk of ``zc``
    planes: tile ``(i, j)`` rows ``[8 i, 8 i + 8)`` and columns ``[128 j,
    128 j + 128)``, chunk ``c`` planes ``[c·zc, (c+1)·zc)``.  ``zc`` is the
    largest power of two up to ``K3_PLANES`` (and at most nz) that still
    gives ``K3_BLOCKS_PER_SM`` blocks an SM, else 1: a chunk reads its two
    neighbouring planes besides its own, so longer chunks read fewer."""
    ty, tx = -(-ny // K3_TILE[0]), -(-nx // K3_TILE[1])
    zc = K3_PLANES
    while zc > 1 and ty * tx * -(-nz // zc) < K3_BLOCKS_PER_SM * sms:
        zc //= 2
    zc = min(zc, nz)
    return zc, ty, tx, -(-nz // zc)


_sweep_fn = None


def _sweep_kernel():
    global _sweep_fn
    if _sweep_fn is None:
        from openmg_tpu_torch import _build

        fn = _build.load().omg_half_sweep
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, p, i, p,      # coef, table, offs, K, rowmap
            i, i, f, i,         # vary, mode, omega, color
            p, p, p, p, p,      # b, x, lower, upper, out
            i, i, i, i, i, p,   # nz, ny, nx, zc, members, stream
        ]
        fn.restype = i
        tile = _build.load().omg_half_sweep_tile
        tile.restype = i
        if (tile(1), tile(0)) != K3_TILE:
            raise RuntimeError(
                f"csrc/half_sweep.cu tiles {tile(1)} x {tile(0)}, the wrapper "
                f"plans {K3_TILE[0]} x {K3_TILE[1]}"
            )
        _sweep_fn = fn
    return _sweep_fn


def _half_sweep_cuda(coef, offsets, b, x, mode, omega, color, vary, corner,
                     halos=None, batch=False):
    """Launch one pass of ``csrc/half_sweep.cu``; returns the new array.
    ``halos``: the ``(lower, upper)`` planes a halo form reads.  ``batch``:
    ``b`` and ``x`` are ``(K, nz, ny, nx)`` stacks, one launch for all
    members (K3b, K4b; with ``halos``, each member's ``(K, 1, ny, nx)``
    planes: K3hb, K4hb), the operator shared."""
    global LAUNCHES_K3, LAUNCHES_K4, LAUNCHES_K3_HALO, LAUNCHES_K4_HALO
    global LAUNCHES_K3_BATCH, LAUNCHES_K4_BATCH
    global LAUNCHES_K3_HALO_BATCH, LAUNCHES_K4_HALO_BATCH
    from openmg_tpu_torch.ops.fused import _check, _row_map

    if mode not in _MODE_CODE:
        raise ValueError(f"unknown mode {mode!r}; choose jacobi|rbgs|residual")
    dev = x.device
    if x.ndim != 3 + int(batch) or any(len(off) != 3 for off in offsets):
        what = "(K, nz, ny, nx) batches" if batch else "3D grids"
        raise ValueError(
            f"the kernel takes {what} and 3D taps, got shape {tuple(x.shape)}"
        )
    if batch and x.shape[0] < 1:
        raise ValueError("a batch of at least one member")
    full = tuple(x.shape)
    shape = full[-3:]
    K = len(offsets)
    why = kernel_taps_ok(offsets)
    if why is not None:
        raise ValueError(f"the kernel does not take {why}")
    _check("x", x, full, dev)
    _check("b", b, full, dev)
    table = None
    if vary:
        _check("coeffs", coef, (K,) + shape, dev)
        if corner:
            raise ValueError("corner= belongs to constant taps")
    else:
        _check("values", coef, (K,), dev)
        if corner:
            table = corner[1]
            _check("region table", table, (len(corner[0]), K), dev)
    lower = upper = None
    if halos is not None:
        lower, upper = halos
        _check("lower halo", lower, full[:-3] + (1,) + shape[1:], dev)
        _check("upper halo", upper, full[:-3] + (1,) + shape[1:], dev)
    out = torch.empty_like(x)
    zc = 0 if vary else sweep_plan(*shape, _sms(dev))[0]
    offs_c = (ctypes.c_int * (3 * K))(*[o for off in offsets for o in off])
    rowmap_c = (ctypes.c_int * 8)(*_row_map(corner))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _sweep_kernel()(
            coef.data_ptr(), None if table is None else table.data_ptr(),
            offs_c, K, rowmap_c, int(bool(vary)), _MODE_CODE[mode],
            float(omega), int(color), b.data_ptr(), x.data_ptr(),
            None if lower is None else lower.data_ptr(),
            None if upper is None else upper.data_ptr(),
            out.data_ptr(), shape[0], shape[1], shape[2], zc,
            full[0] if batch else 1, stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_half_sweep failed with code {rc}")
    if batch and halos is not None:
        if vary:
            LAUNCHES_K4_HALO_BATCH += 1
        else:
            LAUNCHES_K3_HALO_BATCH += 1
    elif batch:
        if vary:
            LAUNCHES_K4_BATCH += 1
        else:
            LAUNCHES_K3_BATCH += 1
    elif halos is not None:
        if vary:
            LAUNCHES_K4_HALO += 1
        else:
            LAUNCHES_K3_HALO += 1
    elif vary:
        LAUNCHES_K4 += 1
    else:
        LAUNCHES_K3 += 1
    return out


def _half_sweep(values, b, x, *, offsets, mode, omega, color, corner=None):
    """One constant-tap pass (K3) on 3D operands, by the device of ``x``.

    A cornered operator (``corner=``) is one launch too: the kernel picks a
    point's tap row and diagonal from the region table by its coordinates,
    as the fused kernel does.  (The JAX package runs its constant kernel and
    then repairs the low faces, edges and corner in separate passes.)"""
    if x.device.type == "cpu":
        return half_sweep_plain(values, offsets, b, x, mode, omega, color, corner)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _half_sweep_cuda(values, offsets, b, x, mode, omega, color, False, corner)


def _half_sweep_vary(coeffs, b, x, *, offsets, mode, omega, color):
    """One varying-coefficient pass (K4) on 3D operands, by the device of
    ``x``."""
    if x.device.type == "cpu":
        return half_sweep_vary_plain(coeffs, offsets, b, x, mode, omega, color)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _half_sweep_cuda(coeffs, offsets, b, x, mode, omega, color, True, None)


def _slab_lift(offsets, corner, *grids):
    """A 2D slab ``(ny, nx)`` partitioned along y as the 3D slab
    ``(ny, 1, nx)``: the partition axis becomes the kernels' z axis, so a
    halo form takes its received rows as planes.  Offsets ``(oy, ox)`` go to
    ``(oy, 0, ox)`` and the region axes of a cornered operator move the
    same way; coefficient grids ``(K, ny, nx)`` go to ``(K, ny, 1, nx)``."""
    offs = tuple((o[0], 0, o[1]) for o in offsets)
    if corner:
        regions, table = corner
        corner = (tuple(tuple(2 * a for a in R) for R in regions), table)
    ups = tuple(
        None if g is None else g.unsqueeze(-2) for g in grids
    )
    return offs, corner, ups


def halo_half_sweep_const_3d(values, offsets, b, x, mode: str, omega: float,
                             color: int, lower, upper, corner=None, open_lo=0):
    """One constant-tap pass (``mode`` jacobi|rbgs|residual) on a rank's
    slab, with the planes ``lower`` / ``upper`` received from the ranks
    below and above (zeros at the domain edges) read by the kernel at the
    slab's first and last plane: one launch (K3), no epilogue.

    ``corner``: a cornered operator's ``(regions, table)``; its regions on
    axis 0 lie at the global plane 0, so a rank with a neighbour below
    (``open_lo``) drops them (the other regions span every rank).  A 2D
    slab ``(ny, nx)`` with halo rows ``(1, nx)`` runs as ``(ny, 1, nx)``.
    A red/black colour is the parity of the local index: the partition
    keeps every slab's first global index even."""
    from openmg_tpu_torch.ops.fused import gate_corner

    offsets = _norm_offsets(offsets)
    corner = gate_corner(corner, open_lo)
    if x.ndim == 2:
        offs, corner, (bb, xx, lo, up) = _slab_lift(offsets, corner, b, x, lower, upper)
        out = halo_half_sweep_const_3d(
            values, offs, bb, xx, mode, omega, color, lo, up, corner=corner
        )
        return out.reshape(x.shape)
    if x.device.type == "cpu":
        return half_sweep_plain(values, offsets, b, x, mode, omega, color, corner,
                                halos=(lower, upper))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _half_sweep_cuda(values, offsets, b, x, mode, omega, color, False, corner,
                            halos=(lower, upper))


def halo_half_sweep_vary_3d(coeffs, offsets, b, x, mode: str, omega: float,
                            color: int, lower, upper):
    """The varying-coefficient twin of :func:`halo_half_sweep_const_3d`
    (K4's per-pass kernel; ``coeffs`` holds the slab's own coefficient
    grids).  The leg kernel (``csrc/vary_leg.cu``) takes no halos: the
    partitioned varying tier is a pass a launch, as in the JAX package."""
    offsets = _norm_offsets(offsets)
    if x.ndim == 2:
        offs, _, (cc, bb, xx, lo, up) = _slab_lift(
            offsets, None, coeffs, b, x, lower, upper
        )
        out = halo_half_sweep_vary_3d(cc, offs, bb, xx, mode, omega, color, lo, up)
        return out.reshape(x.shape)
    if x.device.type == "cpu":
        return half_sweep_vary_plain(coeffs, offsets, b, x, mode, omega, color,
                                     halos=(lower, upper))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _half_sweep_cuda(coeffs, offsets, b, x, mode, omega, color, True, None,
                            halos=(lower, upper))


def _lift_corner(corner, ndim=2):
    """The region table of a cornered 2D (or 1D) operator for its
    ``(1, ny, nx)`` (or ``(1, 1, n)``) lift: the face axes move up by the
    lifted axes in front (which are 0 everywhere and select no row)."""
    if not corner:
        return None
    regions, table = corner
    up = 3 - ndim
    return tuple(tuple(a + up for a in R) for R in regions), table


def _lifted(fn, first, offsets, b, x, *rest, vary=False, **kw):
    """Run a 3D entry point on 1D or 2D operands lifted to ``(1, 1, n)`` or
    ``(1, ny, nx)``."""
    if kw.get("corner"):
        kw["corner"] = _lift_corner(kw["corner"], x.ndim)
    first = _up_coeffs(first, x) if vary else first
    out = fn(first, _lift(offsets), _up(b), _up(x), *rest, **kw)
    return out.reshape(x.shape)


def residual_const_3d(values, offsets, b, x, corner=None):
    """Residual ``r = b − A x`` of a 1D/2D/3D constant (or, with ``corner=``,
    cornered) stencil: one pass."""
    if x.ndim in (1, 2):
        return _lifted(residual_const_3d, values, offsets, b, x, corner=corner)
    return _half_sweep(
        values, b, x, offsets=_norm_offsets(offsets), mode="residual",
        omega=0.0, color=0, corner=corner,
    )


def jacobi_const_3d(values, offsets, b, x, iterations: int, omega: float,
                    corner=None):
    """Weighted-Jacobi sweeps of a 1D/2D/3D constant stencil, one pass each."""
    if x.ndim in (1, 2):
        return _lifted(
            jacobi_const_3d, values, offsets, b, x, iterations, omega,
            corner=corner,
        )
    offsets = _norm_offsets(offsets)
    for _ in range(iterations):
        x = _half_sweep(
            values, b, x, offsets=offsets, mode="jacobi", omega=omega,
            color=0, corner=corner,
        )
    return x


def rbgs_const_3d(values, offsets, b, x, iterations: int, corner=None):
    """Red–black Gauss–Seidel sweeps of a 1D/2D/3D constant stencil, two
    passes each."""
    if x.ndim in (1, 2):
        return _lifted(
            rbgs_const_3d, values, offsets, b, x, iterations, corner=corner
        )
    offsets = _norm_offsets(offsets)
    for _ in range(iterations):
        for color in (0, 1):
            x = _half_sweep(
                values, b, x, offsets=offsets, mode="rbgs", omega=0.0,
                color=color, corner=corner,
            )
    return x


def rbgs_half_sweep_const_3d(values, offsets, b, x, color: int, corner=None):
    """One single-colour red/black pass of a 1D/2D/3D constant stencil."""
    if x.ndim in (1, 2):
        return _lifted(
            rbgs_half_sweep_const_3d, values, offsets, b, x, color,
            corner=corner,
        )
    return _half_sweep(
        values, b, x, offsets=_norm_offsets(offsets), mode="rbgs", omega=0.0,
        color=color, corner=corner,
    )


def jacobi_vary_3d(coeffs, offsets, b, x, iterations: int, omega: float):
    """Weighted-Jacobi sweeps of a varying-coefficient 1D/2D/3D stencil (one
    pass per sweep: K coefficient grids, x and b in, x out)."""
    if x.ndim in (1, 2):
        return _lifted(
            jacobi_vary_3d, coeffs, offsets, b, x, iterations, omega, vary=True
        )
    offsets = _norm_offsets(offsets)
    for _ in range(iterations):
        x = _half_sweep_vary(
            coeffs, b, x, offsets=offsets, mode="jacobi", omega=omega, color=0
        )
    return x


def rbgs_vary_3d(coeffs, offsets, b, x, iterations: int):
    """Red–black Gauss–Seidel sweeps of a varying-coefficient 1D/2D/3D
    stencil."""
    if x.ndim in (1, 2):
        return _lifted(rbgs_vary_3d, coeffs, offsets, b, x, iterations, vary=True)
    offsets = _norm_offsets(offsets)
    for _ in range(iterations):
        for color in (0, 1):
            x = _half_sweep_vary(
                coeffs, b, x, offsets=offsets, mode="rbgs", omega=0.0,
                color=color,
            )
    return x


def rbgs_half_sweep_vary_3d(coeffs, offsets, b, x, color: int):
    """One single-colour red/black pass of a varying-coefficient stencil."""
    if x.ndim in (1, 2):
        return _lifted(
            rbgs_half_sweep_vary_3d, coeffs, offsets, b, x, color, vary=True
        )
    return _half_sweep_vary(
        coeffs, b, x, offsets=_norm_offsets(offsets), mode="rbgs", omega=0.0,
        color=color,
    )


def residual_vary_3d(coeffs, offsets, b, x):
    """Residual of a varying-coefficient 1D/2D/3D stencil: one pass."""
    if x.ndim in (1, 2):
        return _lifted(residual_vary_3d, coeffs, offsets, b, x, vary=True)
    return _half_sweep_vary(
        coeffs, b, x, offsets=_norm_offsets(offsets), mode="residual",
        omega=0.0, color=0,
    )


# ---------------------------------------------------------------------------
# one leg of a varying-level visit (K4, csrc/vary_leg.cu)
# ---------------------------------------------------------------------------

# the most passes (+1 with the residual) one launch of csrc/vary_leg.cu
# takes (its MAX_LEG): a deeper launch recomputes a wider halo of its tile
# at every level
LEG_DEPTH = 3
# the most taps the kernel's coefficient ring takes (its RING_MAXK)
RING_MAX_TAPS = 9
# an H100's L2 cache
L2_BYTES = 50 * 2 ** 20


def leg_depth(taps: int, points: int) -> int:
    """Passes (+1 with the residual) one launch of a leg takes for an
    operator of ``taps`` coefficient grids of ``points`` points each:
    ``LEG_DEPTH`` up to 7 taps, or where the grids fit in L2 (a launch's
    later levels then read them there), else 1, a pass a launch.  A
    27-point level of 128³ points holds 226 MB of grids: its fused
    launches, reading them again from device memory at every level,
    measured slower than a pass a launch; at 64³ (28 MB) they were faster,
    and they take fewer launches, whose host cost is larger than a pass's
    device time there (PERF.md §6)."""
    if taps <= 7 or 4 * taps * points <= L2_BYTES:
        return LEG_DEPTH
    return 1


def leg_ring(taps: int, depth: int, mode: str) -> bool:
    """Whether a launch of ``depth`` levels reads its coefficients from the
    kernel's shared-memory ring instead of device memory: Jacobi launches
    of depth 2 and up to ``RING_MAX_TAPS`` taps.  Deeper or denser, the
    ring leaves no tile of useful height; on red/black passes, which
    compute half the cells a level, it measured a few percent slower than
    none, on Jacobi launches about a third faster (PERF.md §6)."""
    return mode == "jacobi" and depth == 2 and taps <= RING_MAX_TAPS


def leg_chunks(passes: int, emit_residual: bool, depth_cap: int):
    """The launches of a leg: ``(first pass, passes, residual)`` each, as
    few as ``depth_cap`` passes (+1 with the residual) a launch allow and
    as even as can be, the deeper ones and the residual last."""
    depth = passes + int(bool(emit_residual))
    k = -(-depth // depth_cap)
    out, start = [], 0
    for i in range(k):
        # the larger chunks last: the residual's launch takes the extra level
        size = depth // k + (1 if i >= k - depth % k else 0)
        last = i == k - 1
        n = size - int(bool(emit_residual) and last)
        out.append((start, n, bool(emit_residual) and last))
        start += n
    return out


def _up_coeffs(coeffs, b):
    """``(K, *grid)`` coefficient grids of a 1D or 2D operator on the lift
    of ``b``."""
    return coeffs.reshape((coeffs.shape[0],) + tuple(_up(b).shape))


def sweeps_vary_plain(coeffs, offsets, b, x, passes, mode="rbgs",
                      omega=2.0 / 3.0, emit_residual=False, inv_diag=None):
    """Plain PyTorch version of a leg: ``passes`` passes of
    :func:`half_sweep_vary_plain` from ``x`` (zero when None), red/black
    colours 0, 1, 0, …, then with ``emit_residual`` the residual of the
    last iterate; returns ``x`` or ``(x, r)``.
    ``inv_diag``: the grid of ``1 / coeffs[diag]`` where the caller keeps
    one (a level's ``inv_diag``), else it is formed here.  2D operands
    run as ``(1, ny, nx)``, 1D ones as ``(1, 1, n)``."""
    if b.ndim in (1, 2):
        got = sweeps_vary_plain(
            _up_coeffs(coeffs, b), _lift(offsets), _up(b), _up(x), passes,
            mode, omega, emit_residual, _up(inv_diag),
        )
        if emit_residual:
            return tuple(t.reshape(b.shape) for t in got)
        return got.reshape(b.shape)
    offsets = _norm_offsets(offsets)
    if inv_diag is None:
        inv_diag = 1.0 / coeffs[diag_index(offsets)]
    if x is None:
        x = torch.zeros_like(b)
    for j in range(passes):
        color = j & 1 if mode == "rbgs" else 0
        x = _pass_plain(coeffs, offsets, b, x, mode, omega, color, inv_diag, None)
    if not emit_residual:
        return x
    return x, _pass_plain(coeffs, offsets, b, x, "residual", 0.0, 0, inv_diag, None)


_leg_fn = None


def _leg_kernel():
    global _leg_fn
    if _leg_fn is None:
        from openmg_tpu_torch import _build

        fn = _build.load().omg_vary_leg
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, p, i,         # coef, inv_diag, offs, K
            p, p, p, p,         # b, x_in, x_out, r_out
            i, i, i,            # nz, ny, nx
            i, i, f, i, i,      # passes, mode, omega, color0, residual
            i, i, p,            # ring, members, stream
        ]
        fn.restype = i
        _leg_fn = fn
    return _leg_fn


def _vary_leg_cuda(coeffs, offsets, b, x, passes, mode, omega, emit_residual,
                   color0, inv_diag=None, batch=False):
    """One launch of ``csrc/vary_leg.cu``: ``passes`` passes (colours from
    ``color0``) and the residual, 2 or 3 levels; returns ``x`` or
    ``(x, r)``.  ``batch``: ``b`` and ``x`` are ``(K, nz, ny, nx)`` stacks,
    one launch for all members (K4b), the coefficients shared."""
    global LAUNCHES_K4, LAUNCHES_K4_BATCH
    from openmg_tpu_torch.ops.fused import _check

    if mode not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown mode {mode!r}; choose jacobi|rbgs")
    dev = b.device
    if b.ndim != 3 + int(batch) or any(len(off) != 3 for off in offsets):
        what = "(K, nz, ny, nx) batches" if batch else "3D grids"
        raise ValueError(
            f"the kernel takes {what} and 3D taps, got shape {tuple(b.shape)}"
        )
    if batch and b.shape[0] < 1:
        raise ValueError("a batch of at least one member")
    full = tuple(b.shape)
    shape = full[-3:]
    K = len(offsets)
    why = kernel_taps_ok(offsets)
    if why is not None:
        raise ValueError(f"the kernel does not take {why}")
    _check("b", b, full, dev)
    _check("coeffs", coeffs, (K,) + shape, dev)
    if x is not None:
        _check("x", x, full, dev)
    if inv_diag is not None:
        _check("inv_diag", inv_diag, shape, dev)
    x_out = torch.empty_like(b) if passes else None
    r_out = torch.empty_like(b) if emit_residual else None
    offs_c = (ctypes.c_int * (3 * K))(*[o for off in offsets for o in off])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _leg_kernel()(
            coeffs.data_ptr(), None if inv_diag is None else inv_diag.data_ptr(),
            offs_c, K, b.data_ptr(),
            None if x is None else x.data_ptr(),
            None if x_out is None else x_out.data_ptr(),
            None if r_out is None else r_out.data_ptr(),
            shape[0], shape[1], shape[2], int(passes),
            _MODE_CODE[mode], float(omega), int(color0), int(emit_residual),
            int(leg_ring(K, passes + int(emit_residual), mode)),
            full[0] if batch else 1, stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_vary_leg failed with code {rc}")
    if batch:
        LAUNCHES_K4_BATCH += 1
    else:
        LAUNCHES_K4 += 1
    if x_out is None:
        x_out = torch.zeros_like(b) if x is None else x
    return (x_out, r_out) if emit_residual else x_out


def sweeps_vary_3d(coeffs, offsets, b, x, passes: int, mode="rbgs",
                   omega=2.0 / 3.0, emit_residual=False, inv_diag=None):
    """A leg of a varying-level visit on 1D/2D/3D operands, by the device of
    ``b``: ``passes`` Jacobi or red/black passes (colours 0, 1, 0, … — a
    red/black sweep is two passes) from ``x``, or from zero when ``x`` is
    None (then never read), and with ``emit_residual`` the residual of the
    last iterate.  Returns ``x`` or ``(x, r)``.  ``inv_diag``: the grid of
    ``1 / coeffs[diag]`` where the caller keeps one (read instead of
    forming it).  On the card one launch of K4 takes up to
    :func:`leg_depth` passes and the residual; a deeper leg takes
    ``⌈depth / leg_depth⌉`` (:func:`leg_chunks`), and a launch of one
    level is a pass of ``csrc/half_sweep.cu``."""
    if b.ndim in (1, 2):
        got = sweeps_vary_3d(
            _up_coeffs(coeffs, b), _lift(offsets), _up(b), _up(x), passes,
            mode, omega, emit_residual, _up(inv_diag),
        )
        if emit_residual:
            return tuple(t.reshape(b.shape) for t in got)
        return got.reshape(b.shape)
    offsets = _norm_offsets(offsets)
    if b.device.type == "cpu":
        return sweeps_vary_plain(
            coeffs, offsets, b, x, passes, mode, omega, emit_residual,
            inv_diag=inv_diag,
        )
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    if passes == 0 and not emit_residual:
        return torch.zeros_like(b) if x is None else x
    cap = leg_depth(len(offsets), b.numel())
    for start, n, res in leg_chunks(passes, emit_residual, cap):
        if n + res > 1:
            out = _vary_leg_cuda(
                coeffs, offsets, b, x, n, mode, omega, res, start & 1, inv_diag,
            )
        else:
            # one level: the per-pass kernel of csrc/half_sweep.cu
            y = torch.zeros_like(b) if x is None else x
            m = "residual" if res else mode
            out = _half_sweep_cuda(
                coeffs, offsets, b, y, m, omega, start & 1, True, None
            )
            out = (y, out) if res else out
        x = out[0] if res else out
    return out


# ---------------------------------------------------------------------------
# the batched forms of K3 and K4 (K members of one grid a launch)
# ---------------------------------------------------------------------------


def _lift_batch(offsets, nd, *grids):
    """Offsets of an ``nd``-dimensional operator on its 3D lift, and
    ``(K, *grid)`` stacks as ``(K, nz, ny, nx)`` (views where they can be;
    None passes through)."""
    if nd == 3:
        return offsets, grids
    ups = tuple(
        None if g is None
        else g.reshape(g.shape[:1] + (1,) * (3 - nd) + tuple(g.shape[1:]))
        for g in grids
    )
    return _lift(offsets), ups


def half_sweep_batch_plain(values, offsets, b, x, mode, omega=0.0, color=0,
                           corner=None):
    """Plain version of :func:`half_sweep_batch`: :func:`half_sweep_plain`
    on each member's 3D lift, stacked."""
    offsets = _norm_offsets(offsets)
    nd = _batch_operands(offsets, (b, x), "K3b")
    offs3, (bb, xx) = _lift_batch(offsets, nd, b, x)
    corner3 = _lift_corner(corner, nd) if nd < 3 else corner
    return torch.stack([
        half_sweep_plain(values, offs3, bb[m], xx[m], mode, omega, color, corner3)
        for m in range(x.shape[0])
    ]).reshape(x.shape)


def half_sweep_batch(values, offsets, b, x, mode, omega=0.0, color=0,
                     corner=None):
    """K3b: one constant-tap (with ``corner=``, cornered) pass in ``mode``
    jacobi|rbgs|residual on K members of one grid at once, ``b`` and ``x``
    ``(K, *grid)`` (a grid of 1, 2 or 3 dimensions, by the offsets; the
    operator shared).  On a CUDA tensor one launch for the batch, each
    member bit-equal to the scalar launch on it; on a CPU tensor the plain
    version."""
    offsets = _norm_offsets(offsets)
    nd = _batch_operands(offsets, (b, x), "K3b")
    if x.device.type == "cpu":
        return half_sweep_batch_plain(values, offsets, b, x, mode, omega, color,
                                      corner)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    offs3, (bb, xx) = _lift_batch(offsets, nd, b, x)
    corner3 = _lift_corner(corner, nd) if nd < 3 else corner
    out = _half_sweep_cuda(values, offs3, bb.contiguous(), xx.contiguous(), mode,
                           omega, color, False, corner3, batch=True)
    return out.reshape(x.shape)


def half_sweep_vary_batch_plain(coeffs, offsets, b, x, mode, omega=0.0, color=0):
    """Plain version of :func:`half_sweep_vary_batch`:
    :func:`half_sweep_vary_plain` on each member's 3D lift, stacked."""
    offsets = _norm_offsets(offsets)
    nd = _batch_operands(offsets, (b, x), "K4b")
    offs3, (bb, xx) = _lift_batch(offsets, nd, b, x)
    cc = _up_coeffs(coeffs, bb[0])
    return torch.stack([
        half_sweep_vary_plain(cc, offs3, bb[m], xx[m], mode, omega, color)
        for m in range(x.shape[0])
    ]).reshape(x.shape)


def half_sweep_vary_batch(coeffs, offsets, b, x, mode, omega=0.0, color=0):
    """K4b's single pass: :func:`half_sweep_vary_batch_plain`'s pass on K
    members of one grid at once, ``b`` and ``x`` ``(K, *grid)``, the
    coefficient grids ``(T, *grid)`` shared.  On a CUDA tensor one launch of
    ``csrc/half_sweep.cu``'s varying pass for the batch, each member
    bit-equal to the scalar launch; on a CPU tensor the plain version."""
    offsets = _norm_offsets(offsets)
    nd = _batch_operands(offsets, (b, x), "K4b")
    if x.device.type == "cpu":
        return half_sweep_vary_batch_plain(coeffs, offsets, b, x, mode, omega,
                                           color)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    offs3, (bb, xx) = _lift_batch(offsets, nd, b, x)
    out = _half_sweep_cuda(_up_coeffs(coeffs, bb[0]), offs3, bb.contiguous(),
                           xx.contiguous(), mode, omega, color, True, None,
                           batch=True)
    return out.reshape(x.shape)


def _halo_batch_operands(offsets, b, x, lower, upper, what):
    """The slab's dimension of a halo batch (by the offsets: 3, or 2 for a
    2D slab cut along y), after checking that ``b`` and ``x`` are ``(K,
    *slab)`` and the received planes ``(K, 1, *plane)``."""
    nd = _batch_operands(offsets, (b, x), what)
    if nd not in (2, 3):
        raise ValueError(f"{what} takes 3D slabs, or 2D slabs cut along y")
    want = (x.shape[0], 1) + tuple(x.shape[2:])
    for name, t in (("lower", lower), ("upper", upper)):
        if tuple(t.shape) != want:
            raise ValueError(
                f"{what}: {name} planes of shape {tuple(t.shape)}, expected {want}"
            )
    return nd


def halo_half_sweep_batch_plain(values, offsets, b, x, mode, omega, color,
                                lower, upper, corner=None):
    """Plain version of :func:`halo_half_sweep_batch`: the scalar halo
    form's plain version on each member (``corner`` already gated),
    stacked."""
    offsets = _norm_offsets(offsets)
    shape = x.shape
    if _halo_batch_operands(offsets, b, x, lower, upper, "K3hb") == 2:
        offsets, corner, (b, x, lower, upper) = _slab_lift(
            offsets, corner, b, x, lower, upper)
    return torch.stack([
        half_sweep_plain(values, offsets, b[m], x[m], mode, omega, color, corner,
                         halos=(lower[m], upper[m]))
        for m in range(shape[0])
    ]).reshape(shape)


def halo_half_sweep_batch(values, offsets, b, x, mode: str, omega: float,
                          color: int, lower, upper, corner=None, open_lo=0):
    """K3hb: :func:`halo_half_sweep_const_3d` on K members of a rank's slab
    at once: ``b`` and ``x`` ``(K, *slab)``, each member's received planes
    ``lower`` / ``upper`` ``(K, 1, *plane)``, the operator shared.  A 2D
    slab (by the offsets) runs as ``(K, ny, 1, nx)``.  On a CUDA tensor one
    launch for the batch, each member bit-equal to the scalar halo launch
    on it; on a CPU tensor the plain version."""
    from openmg_tpu_torch.ops.fused import gate_corner

    offsets = _norm_offsets(offsets)
    corner = gate_corner(corner, open_lo)
    if x.device.type == "cpu":
        return halo_half_sweep_batch_plain(values, offsets, b, x, mode, omega,
                                           color, lower, upper, corner)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if _halo_batch_operands(offsets, b, x, lower, upper, "K3hb") == 2:
        offs, corner, (bb, xx, lo, up) = _slab_lift(offsets, corner, b, x, lower, upper)
        out = _half_sweep_cuda(values, offs, bb, xx, mode, omega, color, False, corner,
                               halos=(lo, up), batch=True)
        return out.reshape(x.shape)
    return _half_sweep_cuda(values, offsets, b, x, mode, omega, color, False, corner,
                            halos=(lower, upper), batch=True)


def halo_half_sweep_vary_batch_plain(coeffs, offsets, b, x, mode, omega, color,
                                     lower, upper):
    """Plain version of :func:`halo_half_sweep_vary_batch`: the scalar halo
    form's plain version on each member, stacked."""
    offsets = _norm_offsets(offsets)
    shape = x.shape
    if _halo_batch_operands(offsets, b, x, lower, upper, "K4hb") == 2:
        offsets, _, (coeffs, b, x, lower, upper) = _slab_lift(
            offsets, None, coeffs, b, x, lower, upper)
    return torch.stack([
        half_sweep_vary_plain(coeffs, offsets, b[m], x[m], mode, omega, color,
                              halos=(lower[m], upper[m]))
        for m in range(shape[0])
    ]).reshape(shape)


def halo_half_sweep_vary_batch(coeffs, offsets, b, x, mode: str, omega: float,
                               color: int, lower, upper):
    """K4hb: :func:`halo_half_sweep_vary_3d` on K members of a rank's slab
    at once (``coeffs`` the slab's own coefficient grids, shared; the rest
    as :func:`halo_half_sweep_batch`): one launch of ``csrc/half_sweep.cu``'s
    varying pass for the batch, a pass a launch as K4h."""
    offsets = _norm_offsets(offsets)
    if x.device.type == "cpu":
        return halo_half_sweep_vary_batch_plain(coeffs, offsets, b, x, mode, omega,
                                                color, lower, upper)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if _halo_batch_operands(offsets, b, x, lower, upper, "K4hb") == 2:
        offs, _, (cc, bb, xx, lo, up) = _slab_lift(offsets, None, coeffs, b, x,
                                                   lower, upper)
        out = _half_sweep_cuda(cc, offs, bb, xx, mode, omega, color, True, None,
                               halos=(lo, up), batch=True)
        return out.reshape(x.shape)
    return _half_sweep_cuda(coeffs, offsets, b, x, mode, omega, color, True, None,
                            halos=(lower, upper), batch=True)


def sweeps_vary_batch_plain(coeffs, offsets, b, x, passes, mode="rbgs",
                            omega=2.0 / 3.0, emit_residual=False, inv_diag=None):
    """Plain version of :func:`sweeps_vary_batch`: :func:`sweeps_vary_plain`
    on each member, stacked."""
    offsets = _norm_offsets(offsets)
    _batch_operands(offsets, (b,) if x is None else (b, x), "K4b")
    outs = [
        sweeps_vary_plain(coeffs, offsets, b[m], None if x is None else x[m],
                          passes, mode, omega, emit_residual, inv_diag)
        for m in range(b.shape[0])
    ]
    if emit_residual:
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return torch.stack(outs)


def sweeps_vary_batch(coeffs, offsets, b, x, passes: int, mode="rbgs",
                      omega=2.0 / 3.0, emit_residual=False, inv_diag=None):
    """K4b: the leg of :func:`sweeps_vary_3d` on K members of one grid at
    once, ``b`` and ``x`` ``(K, *grid)`` (``x`` None: a zero start), the
    coefficient grids and ``inv_diag`` shared; returns ``x`` or ``(x, r)``
    stacked.  On the card the leg takes the scalar leg's launches
    (:func:`leg_chunks` at :func:`leg_depth` of one member's points, the
    ring by :func:`leg_ring`: a batch changes neither fit, see
    ``csrc/vary_leg.cu``), each one launch for the whole batch, so every
    member is bit-equal to its scalar leg; on a CPU tensor the plain
    version, member by member."""
    offsets = _norm_offsets(offsets)
    nd = _batch_operands(offsets, (b,) if x is None else (b, x), "K4b")
    if b.device.type == "cpu":
        return sweeps_vary_batch_plain(coeffs, offsets, b, x, passes, mode, omega,
                                       emit_residual, inv_diag)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    if passes == 0 and not emit_residual:
        return torch.zeros_like(b) if x is None else x
    shape = b.shape
    offs3, (bb, xx) = _lift_batch(offsets, nd, b, x)
    bb = bb.contiguous()
    xx = None if xx is None else xx.contiguous()
    cc = _up_coeffs(coeffs, bb[0])
    inv = None if inv_diag is None else _up(inv_diag)
    cap = leg_depth(len(offsets), bb[0].numel())
    for start, n, res in leg_chunks(passes, emit_residual, cap):
        if n + res > 1:
            out = _vary_leg_cuda(cc, offs3, bb, xx, n, mode, omega, res, start & 1,
                                 inv, batch=True)
        else:
            y = torch.zeros_like(bb) if xx is None else xx
            m = "residual" if res else mode
            out = _half_sweep_cuda(cc, offs3, bb, y, m, omega, start & 1, True,
                                   None, batch=True)
            out = (y, out) if res else out
        xx = out[0] if res else out
    if emit_residual:
        return out[0].reshape(shape), out[1].reshape(shape)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# whole-visit 2D stage fusion (K5)
# ---------------------------------------------------------------------------

# the deepest visit one launch of csrc/fused_stages_2d.cu takes (stages, +1
# with a residual, +1 more with a restriction); its MAX_DEPTH
MAX_DEPTH_2D = 8
# columns of the strip a warp of csrc/fused_stages_2d.cu marches down (its
# W, four a lane), halo included
K5_STRIP = 128
# the fewest warps a launch should have (per SM) before its chunks get
# shorter; chunks of 32 down to 2 rows
K5_WARPS_PER_SM = 8
K5_ROWS = (32, 16, 8, 4, 2)


def fused2d_plan(ny: int, nx: int, depth: int, sms: int = 132):
    """How a launch of ``csrc/fused_stages_2d.cu`` covers an (ny, nx) plane
    for a visit of ``depth`` (stages, +1 with a residual, +1 with a
    restriction, +1 with a prolongation on load): ``(hp, ow, rows, strips,
    chunks)``.  A warp marches ``rows`` rows (and ``depth`` rows above and
    below them) of a strip of ``K5_STRIP`` columns; it owns the ``ow =
    K5_STRIP − 2·hp`` columns inside a halo of ``hp`` (the depth rounded up
    to a multiple of 4, so every lane's four columns are one aligned word).
    Strip ``i`` owns columns ``[i·ow, (i+1)·ow)``, chunk ``j`` rows
    ``[j·rows, (j+1)·rows)``.  ``rows`` is the longest of ``K5_ROWS`` that
    still gives ``K5_WARPS_PER_SM`` warps an SM, the shortest otherwise:
    longer chunks march fewer halo rows, more warps fill the card."""
    hp = -(-depth // 4) * 4
    ow = K5_STRIP - 2 * hp
    if ow < 4:
        raise ValueError(f"a visit of depth {depth} leaves no column of a strip")
    strips = -(-nx // ow)
    for rows in K5_ROWS:
        if strips * -(-ny // rows) >= K5_WARPS_PER_SM * sms:
            break
    return hp, ow, rows, strips, -(-ny // rows)


_sm_count = {}


def _sms(dev) -> int:
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_count[dev]


def fused_stages_2d_plain(
    values, offsets, b, x, stages, *, corner=None, emit_residual=False,
    restrict_transfer=None, ec=None, prolong_transfer=None,
):
    """Plain PyTorch version of :func:`fused_stages_2d`: whole-plane tensor
    code, stage by stage, in the kernel's order (the 3D plain version of
    :mod:`openmg_tpu_torch.ops.fused` on the ``(1, ny, nx)`` lift, whose
    transfers leave the size-1 axis alone)."""
    from openmg_tpu_torch.ops.fused import fused_stages_const_3d_plain

    out = fused_stages_const_3d_plain(
        values, _lift2d(offsets), b[None], None if x is None else x[None],
        stages, emit_residual, _lift_corner(corner), restrict_transfer,
        None if ec is None else ec[None], prolong_transfer,
    )
    if emit_residual:
        return out[0][0], out[1][0]
    return out[0]


_fused2d_fn = None


def _fused2d_kernel():
    global _fused2d_fn
    if _fused2d_fn is None:
        from openmg_tpu_torch import _build

        lib = _build.load()
        fn = lib.omg_fused_stages_2d
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            p, p, p, i, p,        # values, table, offs, K, rowmap
            p, p, p, p, p,        # b, x, ec, x_out, r_out
            i, i, i, p, p, i,     # ny, nx, n_stages, kinds, pars, emit
            p, p, p, i, p,        # rw, pw, plan, members, stream
        ]
        fn.restype = i
        depth, strip = lib.omg_fused2d_max_depth, lib.omg_fused2d_strip
        depth.restype = strip.restype = i
        if depth() != MAX_DEPTH_2D or strip() != K5_STRIP:
            raise RuntimeError(
                f"csrc/fused_stages_2d.cu takes visits of depth {depth()} on "
                f"strips of {strip()} columns, the wrapper plans depth "
                f"{MAX_DEPTH_2D}, strips of {K5_STRIP}"
            )
        _fused2d_fn = fn
    return _fused2d_fn


def _fused2d_cuda(values, offsets, b, x, stages, *, corner, emit_residual,
                  restrict_transfer, ec, prolong_transfer, batch=False):
    """One launch of ``csrc/fused_stages_2d.cu``: a plane, or with
    ``batch`` a ``(K, ny, nx)`` stack of them."""
    global LAUNCHES_K5, LAUNCHES_K5_BATCH
    from openmg_tpu_torch.ops.fused import (
        _KIND_CODE, _check, _row_map, _transfer_weights,
    )

    dev = b.device
    shape = tuple(b.shape)
    if len(shape) != 2 + int(batch):
        raise ValueError(f"b has shape {shape}")
    lead = shape[:1] if batch else ()
    ny, nx = shape[-2:]
    K = len(offsets)
    if K > 9 or any(len(off) != 2 or abs(o) > 1 for off in offsets for o in off):
        raise ValueError("the kernel takes 2D radius-1 stencils of at most 9 taps")
    _check("b", b, shape, dev)
    _check("values", values, (K,), dev)
    if x is not None:
        _check("x", x, shape, dev)
    table = None
    if corner:
        table = corner[1]
        _check("region table", table, (len(corner[0]), K), dev)
    rw, pw = _transfer_weights(shape[-2:], dev, restrict_transfer, ec,
                               prolong_transfer, lead)
    cshape = lead + (ny // 2, nx // 2)

    x_out = torch.empty_like(b)
    emit, r_out = 0, None
    if emit_residual:
        if restrict_transfer is not None:
            emit, r_out = 2, torch.empty(cshape, dtype=b.dtype, device=dev)
        else:
            emit, r_out = 1, torch.empty_like(b)
    n = len(stages)
    depth = n + (emit > 0) + (emit == 2) + (ec is not None)
    plan = fused2d_plan(ny, nx, depth, _sms(dev))
    offs_c = (ctypes.c_int * (2 * K))(*[o for off in offsets for o in off])
    rowmap_c = (ctypes.c_int * 4)(*_row_map(corner)[:4])
    kinds_c = (ctypes.c_int * max(n, 1))(*[_KIND_CODE[k] for k, _ in stages])
    pars_c = (ctypes.c_float * max(n, 1))(*[float(p) for _, p in stages])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fused2d_kernel()(
            ptr(values), ptr(table), offs_c, K, rowmap_c,
            ptr(b), ptr(x), ptr(ec), ptr(x_out), ptr(r_out),
            ny, nx, n, kinds_c, pars_c, emit,
            (ctypes.c_float * 3)(*rw), (ctypes.c_float * 3)(*pw),
            (ctypes.c_int * 5)(*plan), shape[0] if batch else 1, stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_fused_stages_2d failed with code {rc}")
    if batch:
        LAUNCHES_K5_BATCH += 1
    else:
        LAUNCHES_K5 += 1
    return (x_out, r_out) if emit_residual else x_out


def fused_stages_2d(
    values, offsets, b, x, stages, *, corner=None, emit_residual=False,
    restrict_transfer=None, ec=None, prolong_transfer=None,
):
    """All ``stages`` of a level visit (and optionally the residual) for a
    constant or cornered radius-1 2D stencil, in one launch on the card.
    ``x=None`` is the zero start (reads only ``b``).  Returns ``x'`` or,
    with ``emit_residual``, ``(x', r)``; with ``restrict_transfer`` too,
    ``(x', bc)`` where ``bc = R (b − A x')`` (the fine residual is never
    stored).  ``ec`` + ``prolong_transfer`` start from ``x + P ec`` (never
    stored).  Both transfers need even dims.

    The JAX package's ``deltas=``/``subsets=`` are replaced by
    ``corner=(regions, (n_regions, K) table)`` of a
    :class:`~openmg_tpu_torch.ops.stencil.CorneredOperator`, as in
    :func:`~openmg_tpu_torch.ops.fused.fused_stages_const_3d`.

    Dispatches on the device of ``b``: a CPU tensor runs
    :func:`fused_stages_2d_plain`; a CUDA tensor launches
    ``csrc/fused_stages_2d.cu`` or raises.  A visit deeper than
    ``MAX_DEPTH_2D`` (stages, +1 with a residual, +1 with a restriction) is
    split into consecutive launches on either device; every visit of a
    V-cycle up to V(3,3) is one launch.  Inputs are never modified; on a
    CUDA tensor the call does not wait for the kernel.
    """
    from openmg_tpu_torch.ops.fused import _norm_stages

    offsets = _norm_offsets(offsets)
    stages = _norm_stages(stages)
    if b.ndim != 2:
        raise ValueError(f"b must be 2D, got shape {tuple(b.shape)}")
    _visit_ok(stages, emit_residual, restrict_transfer, ec, True)
    if b.device.type == "cpu":
        one = fused_stages_2d_plain
    elif b.device.type == "cuda":
        one = _fused2d_cuda
    else:
        raise ValueError(f"unsupported device {b.device}")
    return _chunked_2d(one, values, offsets, b, x, stages, corner, emit_residual,
                       restrict_transfer, ec, prolong_transfer)


def _chunked_2d(one, values, offsets, b, x, stages, corner, emit_residual,
                restrict_transfer, ec, prolong_transfer):
    """A visit through ``one`` (a launch or a plain call) in chunks of at
    most ``MAX_DEPTH_2D``."""
    extra = int(emit_residual) + int(restrict_transfer is not None)
    chunks = depth_chunks(stages, extra, MAX_DEPTH_2D)
    for i, chunk in enumerate(chunks):
        last = i == len(chunks) - 1
        out = one(
            values, offsets, b, x, chunk, corner=corner,
            emit_residual=emit_residual and last,
            restrict_transfer=restrict_transfer if last else None,
            ec=ec if i == 0 else None, prolong_transfer=prolong_transfer,
        )
        x = out
    return out


def fused_stages_2d_batch_plain(
    values, offsets, b, x, stages, *, corner=None, emit_residual=False,
    restrict_transfer=None, ec=None, prolong_transfer=None,
):
    """Plain version of :func:`fused_stages_2d_batch`: the scalar plain
    version on each member (in the same chunks), stacked."""
    offsets = _norm_offsets(offsets)
    stages = _norm_stages(stages)
    _batch_operands(offsets, (b,) if x is None else (b, x), "K5b")
    _visit_ok(stages, emit_residual, restrict_transfer, ec, True)
    outs = [
        _chunked_2d(fused_stages_2d_plain, values, offsets, b[m],
                    None if x is None else x[m], stages, corner, emit_residual,
                    restrict_transfer, None if ec is None else ec[m],
                    prolong_transfer)
        for m in range(b.shape[0])
    ]
    if emit_residual:
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return torch.stack(outs)


def fused_stages_2d_batch(
    values, offsets, b, x, stages, *, corner=None, emit_residual=False,
    restrict_transfer=None, ec=None, prolong_transfer=None,
):
    """K5b: :func:`fused_stages_2d` on K planes of one level at once, ``b``
    and ``x`` ``(K, ny, nx)``, ``ec`` ``(K, ny/2, nx/2)``; outputs stacked
    likewise.  On a CUDA tensor one launch a chunk for the whole batch
    (every visit of a V-cycle up to V(3,3) is one), each member bit-equal
    to the scalar launch on it; on a CPU tensor the plain version."""
    if b.device.type == "cpu":
        return fused_stages_2d_batch_plain(
            values, offsets, b, x, stages, corner=corner,
            emit_residual=emit_residual, restrict_transfer=restrict_transfer,
            ec=ec, prolong_transfer=prolong_transfer,
        )
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    offsets = _norm_offsets(offsets)
    stages = _norm_stages(stages)
    _batch_operands(offsets, (b,) if x is None else (b, x), "K5b")
    _visit_ok(stages, emit_residual, restrict_transfer, ec, True)
    return _chunked_2d(
        lambda *a, **kw: _fused2d_cuda(*a, batch=True, **kw), values, offsets,
        b, x, stages, corner, emit_residual, restrict_transfer, ec,
        prolong_transfer,
    )
