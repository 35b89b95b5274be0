"""Galerkin coarsening ``A_c = R A P`` in stencil form (twin of
``openmg_tpu/ops/galerkin.py``; host numpy, copied).

For regular grids with separable tap transfers the triple product has a
closed structured form, computed with strided array ops — no SpGEMM, no
index lists.  The contraction is applied one axis at a time.  For one axis
with restriction taps ``(p, wr)`` and prolongation taps ``(q, wp)``:

    A'[I, I + D]  +=  wr · wp · A[f, f + o]      at  f = 2I + p,
    whenever p + o_axis − q is even,  with  D = (p + o_axis − q) / 2

and all other axes' offsets pass through unchanged.  Contributions that
would target out-of-domain coarse columns are zeroed at the end to keep
the stencil invariant (coeff = 0 where row + offset leaves the grid).

The arithmetic and its order are the JAX package's numpy path exactly, so
the level tables built from it are equal bit for bit.  The same functions
take torch tensors on any device (the JAX package's ``_xp`` lets them take
``jnp`` arrays): :func:`galerkin_rap_device` runs one RAP step on the
tensors' device, as tensor code (the JAX package's is XLA, not a Pallas
kernel), and prunes the offsets that are zero everywhere with one reduction
read to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from openmg_tpu_torch.ops.transfer import AGGREGATE, Transfer, coarse_shape

__all__ = ["galerkin_rap_stencil", "galerkin_rap_device", "rap_output_offsets"]


def _parity_slice(x, pm: int, axis: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(pm, None, 2)
    return x[tuple(idx)]


def _shift_axis_np(x, s: int, axis: int):
    """z[i] = x[i + s] along axis, zero-filled (a numpy array or a tensor)."""
    if s == 0:
        return x
    n = x.shape[axis]
    z = torch.zeros_like(x) if isinstance(x, torch.Tensor) else np.zeros_like(x)
    src = [slice(None)] * x.ndim
    dst = [slice(None)] * x.ndim
    if s > 0:
        dst[axis] = slice(0, n - s)
        src[axis] = slice(s, n)
    else:
        dst[axis] = slice(-s, n)
        src[axis] = slice(0, n + s)
    z[tuple(dst)] = x[tuple(src)]
    return z


def _rap_axis(offsets, coeffs, axis: int, r_taps, p_taps):
    """Contract one grid axis by factor 2 with the given taps (accumulates
    in place: every avoided full-array pass matters at large setups)."""
    on_torch = isinstance(coeffs, torch.Tensor)
    acc: dict = {}
    for k, off in enumerate(offsets):
        ck = coeffs[k]
        o = off[axis]
        for p, wr in r_taps:
            pm = p % 2
            s = (p - pm) // 2
            samp = None  # computed lazily: some (p) rows have no valid q
            for q, wp in p_taps:
                num = p + o - q
                if num % 2:
                    continue
                D = num // 2
                newoff = tuple(
                    D if a == axis else off[a] for a in range(len(off))
                )
                if samp is None:
                    samp = _shift_axis_np(_parity_slice(ck, pm, axis), s, axis)
                w = wr * wp
                if newoff not in acc:
                    acc[newoff] = samp * w  # first term owns the buffer
                elif on_torch:
                    acc[newoff] += samp * w
                else:
                    np.add(acc[newoff], samp * w, out=acc[newoff])
    new_offsets = list(acc.keys())
    stack = torch.stack if on_torch else np.stack
    stacked = stack([acc[D] for D in new_offsets])
    return new_offsets, stacked


def _zero_oob(offsets, coeffs):
    """Enforce the stencil invariant: coeff[k][i] = 0 where i + off OOB
    (mutates ``coeffs``; only thin boundary slices are touched)."""
    shape = coeffs.shape[1:]
    for k, off in enumerate(offsets):
        for axis, o in enumerate(off):
            n = shape[axis]
            if o == 0:
                continue
            idx = [slice(None)] * len(shape)
            idx[axis] = (
                slice(max(0, n - o), n) if o > 0 else slice(0, min(n, -o))
            )
            coeffs[(k,) + tuple(idx)] = 0
    return coeffs


def galerkin_rap_stencil(
    offsets, coeffs, transfer: Transfer = AGGREGATE, prune: bool = True
):
    """Structured RAP on raw ``(offsets, coeffs)``: numpy arrays, or torch
    tensors on any device (the result stays on it).

    Returns coarse ``(offsets, coeffs)``.  ``prune`` drops coarse offsets
    whose coefficient grid is identically zero.
    """
    on_torch = isinstance(coeffs, torch.Tensor)
    if not on_torch:
        coeffs = np.asarray(coeffs)
    shape = tuple(coeffs.shape[1:])
    d = len(shape)
    axes = [a for a in range(d) if shape[a] > 1]
    if any(shape[a] % 2 for a in axes):
        raise ValueError(f"all dims > 1 must be even to coarsen, got {shape}")

    cur_offsets = [tuple(o) for o in offsets]
    cur = coeffs
    for a in axes:
        cur_offsets, cur = _rap_axis(
            cur_offsets, cur, a, transfer.r_taps, transfer.p_taps
        )
    cur = _zero_oob(cur_offsets, cur)
    cur = cur.to(coeffs.dtype) if on_torch else cur.astype(coeffs.dtype, copy=False)
    assert tuple(cur.shape[1:]) == coarse_shape(shape)

    if prune:
        keep = [i for i in range(len(cur_offsets)) if bool((cur[i] != 0).any())]
        if not keep:  # degenerate all-zero operator; keep the diagonal slot
            keep = [0]
        cur_offsets = [cur_offsets[i] for i in keep]
        cur = cur[keep] if on_torch else cur[np.asarray(keep)]

    # diagonal-first convention
    zero = (0,) * d
    order = sorted(
        range(len(cur_offsets)),
        key=lambda i: (cur_offsets[i] != zero, cur_offsets[i]),
    )
    cur_offsets = [cur_offsets[i] for i in order]
    cur = cur[order] if on_torch else cur[np.asarray(order)]
    return tuple(cur_offsets), cur


def rap_output_offsets(offsets, shape, transfer: Transfer = AGGREGATE):
    """The coarse offset list the RAP chain will produce, via a structural
    dry run on a tiny dummy grid with the same dims>1 pattern."""
    dummy_shape = tuple(4 if s > 1 else 1 for s in shape)
    dummy = np.ones((len(offsets),) + dummy_shape, dtype=np.float32)
    offs, _ = galerkin_rap_stencil(offsets, dummy, transfer=transfer, prune=False)
    return offs


def galerkin_rap_device(offsets, coeffs: torch.Tensor, transfer: Transfer = AGGREGATE):
    """One Galerkin step on the device of ``coeffs`` (a ``(K, *grid)``
    tensor): the unpruned RAP as tensor code, its offset list known ahead
    from :func:`rap_output_offsets`, then the offsets whose grid is zero
    everywhere pruned by one reduction read to the host."""
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    shape = tuple(int(s) for s in coeffs.shape[1:])
    out_offsets = rap_output_offsets(offsets, shape, transfer)
    offs, cur = galerkin_rap_stencil(offsets, coeffs, transfer=transfer, prune=False)
    assert tuple(offs) == tuple(out_offsets)
    nz = torch.any(cur.reshape(cur.shape[0], -1) != 0, dim=1).cpu().tolist()
    keep = [i for i in range(len(out_offsets)) if nz[i]] or [0]
    return tuple(out_offsets[i] for i in keep), cur[keep]
