"""Blocked-band BSR SpMV, kernel K7 (twin of ``openmg_tpu/ops/bsr.py``).

A block-banded BSR matrix (every true block of slot ``s`` at block column
``I + d_s``; vector-PDE stencils, any block-banded matrix) is stored
slot-major ``(kb, B, n)``, and its product is

    y[I·B + i] = Σ_j Σ_s data_sm[s, j, I·B + i] · x[(I + d_s)·B + j]

(``x`` outside the matrix is 0), with no gather.  :func:`spmv_bsr`
dispatches on the device of ``x``: a CUDA tensor launches the hand-written
kernel ``csrc/spmv_banded.cu`` (float32 or float64, any block size; the
slot-offset ELL kernel K6 is its block size 1) or raises;
a CPU tensor runs the plain version :func:`spmv_banded_plain`, which sums
with the block column ``j`` outer and the slot ``s`` inner, as the kernel
does, so the two agree bit for bit.  ``LAUNCHES_K7`` counts the launches.

The JAX package's tile-height and ``128 % B`` rules (``pick_tile_rows``)
and its in-register block replicas (``_block_replica``) are that
hardware's and are not copied; block size 3 takes the kernel too.
"""

from __future__ import annotations

import torch

from openmg_tpu_torch.ops.ell import spmv_banded_cuda

__all__ = ["LAUNCHES_K7", "supports", "spmv_banded_plain", "spmv_bsr"]

# launches of the blocked-band BSR kernel (K7)
LAUNCHES_K7 = 0


def supports(M) -> bool:
    """Whether :func:`spmv_bsr` takes ``M``: square with square blocks,
    floating, and block-banded (``slot_offsets``)."""
    n, m = M.shape
    br, bc = M.blocksize
    return (
        n == m and br == bc and M.data.is_floating_point()
        and M.slot_offsets is not None
    )


def _flat_shift(v, d):
    """Zero-filled flat shift ``w[r] = v[r + d]``."""
    if d == 0:
        return v
    z = torch.zeros(abs(d), dtype=v.dtype, device=v.device)
    if d > 0:
        return torch.cat([v[d:], z])
    return torch.cat([z, v[:d]])


def spmv_banded_plain(M, x):
    """Plain PyTorch version of K7 on the slot-major banded layout: for each
    block column ``j`` the block-aligned replica ``z_j[r] = x[r − r%B + j]``,
    shifted by whole blocks per slot."""
    B = M.blocksize[0]
    n = M.shape[0]
    nbr = n // B
    xv = x.reshape(nbr, B)
    acc = None
    for j in range(B):
        zj = xv[:, j:j + 1].expand(nbr, B).reshape(n)
        for s, d in enumerate(M.slot_offsets):
            t = M.data[s, j] * _flat_shift(zj, int(d) * B)
            acc = t if acc is None else acc + t
    return acc


def spmv_bsr(M, x):
    """``y = M x`` for a blocked-band BSR matrix (see :func:`supports`), by
    the device of ``x``: the CUDA kernel on the card, the plain version on
    the CPU."""
    global LAUNCHES_K7
    if not supports(M):
        raise ValueError(
            "spmv_bsr takes a square floating blocked-band BSR matrix with "
            "square blocks"
        )
    if x.device.type == "cpu":
        return spmv_banded_plain(M, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = spmv_banded_cuda("spmv_bsr", M.data, M.slot_offsets, M.blocksize[0], x)
    LAUNCHES_K7 += 1
    return y
