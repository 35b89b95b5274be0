"""The double-float outer step (twin of the
``df_update_residual_const_3d`` part of ``openmg_tpu/ops/kernels.py``).

One pass per outer cycle of the defect-correction loop:

    (x_hi', x_lo') = df_add_f32((x_hi, x_lo), e)
    r_hi           = hi(b − A x')      in double-float

for a constant radius-1 3D stencil whose taps are sums of signed powers of
two (``terms[k] = pow2_terms(values[k])``): every product is exact in
float32, only compensated adds remain.  With ``emit_norm`` the call also
returns partial sums of ``r_hi²`` whose total is ‖r_hi‖²; their number and
layout belong to the implementation (the caller sums them).

:func:`df_update_residual_const_3d` dispatches on the device of ``x_hi``
alone: a CUDA tensor launches the hand-written kernel
(``csrc/df_update.cu``) or raises; a CPU tensor runs
:func:`df_update_residual_const_3d_plain`, which applies the same sequence
of float32 operations in the same order, so the three arrays agree with the
kernel bit for bit.  ``LAUNCHES`` counts the calls that launched the kernel.

The other kernels of the JAX module (per-half-sweep smoothers, varying
coefficients, the 2D whole-plane kernel) and this kernel's 2D lift wait for
later slices.
"""

from __future__ import annotations

import ctypes

import torch

from openmg_tpu_torch.ops.doublefloat import df_add_f32, two_sum
from openmg_tpu_torch.ops.stencil import shift

__all__ = [
    "LAUNCHES",
    "df_update_residual_const_3d",
    "df_update_residual_const_3d_plain",
]

# calls of df_update_residual_const_3d that launched the CUDA kernel
LAUNCHES = 0


def df_update_residual_const_3d_plain(
    offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm: bool = False
):
    """Plain PyTorch version of :func:`df_update_residual_const_3d`, in the
    kernel's order of operations: update every point, then for each offset
    and each of its power-of-two terms ``p`` one compensated
    ``acc ← acc − p·x'[i + off]`` (neighbours outside the domain are zero).
    With ``emit_norm`` the partials are one sum of ``r_hi²`` per z-plane."""
    offsets = tuple(tuple(o) for o in offsets)
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
        return nxh, nxl, acch, torch.sum(acch * acch, dim=(1, 2))
    return nxh, nxl, acch


_fns = None


def _kernel():
    global _fns
    if _fns is None:
        from openmg_tpu_torch import _build

        lib = _build.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.omg_df_update_residual
        fn.argtypes = [p, p, p, i] + [p] * 9 + [i, i, i, p]
        fn.restype = i
        npart = lib.omg_df_num_partials
        npart.argtypes = [i, i, i]
        npart.restype = i
        _fns = (fn, npart)
    return _fns


def _df_update_residual_cuda(offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm):
    global LAUNCHES
    dev = x_hi.device
    if x_hi.ndim != 3:
        raise ValueError(
            f"the kernel takes 3D grids, got shape {tuple(x_hi.shape)} "
            "(the 2D lift is not ported)"
        )
    shape = tuple(x_hi.shape)
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
    K = len(offsets)
    if K > 27 or any(abs(o) > 1 for off in offsets for o in off):
        raise ValueError("the kernel takes radius-1 stencils of at most 27 taps")
    if len(terms) != K or any(t is None or len(t) > 3 for t in terms):
        raise ValueError("every tap needs at most 3 power-of-two terms")

    fn, npart = _kernel()
    nz, ny, nx = shape
    oxh = torch.empty_like(x_hi)
    oxl = torch.empty_like(x_hi)
    orh = torch.empty_like(x_hi)
    partials = (
        torch.empty(npart(nz, ny, nx), dtype=torch.float32, device=dev)
        if emit_norm
        else None
    )
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
            nz, ny, nx, stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_df_update_residual failed with code {rc}")
    LAUNCHES += 1
    if emit_norm:
        return oxh, oxl, orh, partials
    return oxh, oxl, orh


def df_update_residual_const_3d(
    offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm: bool = False
):
    """Outer-loop step for dyadic constant 3D stencils; returns
    ``(x_hi', x_lo', r_hi)`` and, with ``emit_norm``, a 1-D tensor of
    partial sums whose total is ‖r_hi‖².

    ``offsets`` / ``terms`` are static host tuples.  Inputs are never
    modified.  On a CUDA tensor the kernel is enqueued on the current
    stream and the call does not wait for it.
    """
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    terms = tuple(tuple(t) for t in terms)
    if x_hi.device.type == "cpu":
        return df_update_residual_const_3d_plain(
            offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm
        )
    if x_hi.device.type != "cuda":
        raise ValueError(f"unsupported device {x_hi.device}")
    return _df_update_residual_cuda(
        offsets, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm
    )
