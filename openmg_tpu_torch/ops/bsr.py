"""Blocked-band BSR SpMV, kernel K7 (twin of ``openmg_tpu/ops/bsr.py``).

A block-banded BSR matrix (every true block of slot ``s`` at block column
``I + d_s``; vector-PDE stencils, any block-banded matrix) is stored
slot-major ``(kb, B, n)``, and its product is

    y[I·B + i] = Σ_j Σ_s data_sm[s, j, I·B + i] · x[(I + d_s)·B + j]

(``x`` outside the matrix is 0), with no gather.  :func:`spmv_bsr`
dispatches on the device of ``x``: a CUDA tensor launches the hand-written
kernel ``csrc/spmv_banded.cu`` (float32 or float64, any block size; the
slot-offset ELL kernel K6 is its block size 1) or raises;
a CPU tensor runs the plain version :func:`spmv_banded_plain`.  Both split
a row's terms ``t = j·kb + s`` (block column ``j`` outer, slot ``s``
inner) over :func:`lane_group` lanes, lane ``g`` summing ``t ≡ g`` in
order, and add the lanes' partial sums by a pairwise tree, so the two
agree bit for bit.  ``LAUNCHES_K7`` counts the launches.

K7b (:func:`spmv_bsr_batch`, the JAX module's kernel under ``jax.vmap``)
runs ``(K, n)`` vectors through one matrix in one launch of the same
kernel: each data element read once for up to eight members, each
member's lanes and tree those of the scalar launch, so it equals that
launch bit for bit; its plain version :func:`spmv_banded_batch_plain` is
the scalar plain version member by member.  ``LAUNCHES_K7_BATCH`` counts
its launches.

The JAX package's tile-height and ``128 % B`` rules (``pick_tile_rows``)
and its in-register block replicas (``_block_replica``) are that
hardware's and are not copied; block size 3 takes the kernel too.
"""

from __future__ import annotations

import torch

from openmg_tpu_torch.ops.ell import spmv_banded_cuda

__all__ = [
    "LAUNCHES_K7",
    "LAUNCHES_K7_BATCH",
    "lane_group",
    "supports",
    "spmv_banded_plain",
    "spmv_bsr",
    "spmv_banded_batch_plain",
    "spmv_bsr_batch",
]

# launches of the blocked-band BSR kernel (K7) and of its batched form (K7b)
LAUNCHES_K7 = 0
LAUNCHES_K7_BATCH = 0

# the threads a launch should have before a row's terms are shared by more
# lanes, and the most lanes a row: on an H100 (132 SMs) these give the
# measured best lane group of 1, 2, 4 and 8 within 15 % on the levels of the
# 64³ B=4 BSR solve, 2D and 3D elasticity (B = 2, 3) and Poisson 16³ at
# B = 8 (more lanes a row read shorter pieces of more slot planes)
FILL_THREADS = 1 << 18
MAX_LANES = 4


def lane_group(n: int, kb: int, B: int) -> int:
    """Lanes that share a row's ``kb·B`` terms: the smallest power of two
    (at most ``MAX_LANES`` and at most ``kb·B``) for which ``n`` rows give
    ``FILL_THREADS`` threads.  A function of the shape alone, so the plain
    version sums in the kernel's order on any device."""
    g = 1
    while g < MAX_LANES and 2 * g <= kb * B and n * g < FILL_THREADS:
        g *= 2
    return g


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
    """Plain PyTorch version of K7 on the slot-major banded layout, in the
    kernel's order: term ``t = j·kb + s`` is ``data[s, j] ⊙ shift(z_j,
    d_s·B)`` with the block-aligned replica ``z_j[r] = x[r − r%B + j]``;
    lane ``g`` of :func:`lane_group` sums the terms ``t ≡ g`` in order, and
    the partial sums are added pairwise, ``((p0 + p1) + (p2 + p3)) + …``."""
    B = M.blocksize[0]
    n = M.shape[0]
    nbr = n // B
    kb = len(M.slot_offsets)
    xv = x.reshape(nbr, B)
    zs = [xv[:, j:j + 1].expand(nbr, B).reshape(n) for j in range(B)]
    G = lane_group(n, kb, B)
    parts = []
    for g in range(G):
        acc = None
        for t in range(g, kb * B, G):
            j, s = divmod(t, kb)
            term = M.data[s, j] * _flat_shift(zs[j], int(M.slot_offsets[s]) * B)
            acc = term if acc is None else acc + term
        parts.append(acc)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


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
    B = M.blocksize[0]
    y = spmv_banded_cuda(
        "spmv_bsr", M.data, M.slot_offsets, B, x,
        lanes=lane_group(M.shape[0], len(M.slot_offsets), B),
    )
    LAUNCHES_K7 += 1
    return y


def spmv_banded_batch_plain(M, x):
    """Plain version of K7b: :func:`spmv_banded_plain` on each row of the
    ``(K, n)`` ``x``, stacked."""
    return torch.stack([spmv_banded_plain(M, x[m]) for m in range(x.shape[0])])


def spmv_bsr_batch(M, x):
    """K7b: row k of the result is ``M x[k]`` for a blocked-band BSR matrix
    and ``(K, n)`` vectors, by the device of ``x``: one launch of the CUDA
    kernel for all K on the card (the scalar launch's lane group), each row
    bit-equal to :func:`spmv_bsr` of it; the plain version on the CPU."""
    global LAUNCHES_K7_BATCH
    if not supports(M):
        raise ValueError(
            "spmv_bsr_batch takes a square floating blocked-band BSR matrix "
            "with square blocks"
        )
    if x.ndim != 2:
        raise ValueError(f"spmv_bsr_batch: x has shape {tuple(x.shape)}, not (K, n)")
    if x.device.type == "cpu":
        return spmv_banded_batch_plain(M, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B = M.blocksize[0]
    y = spmv_banded_cuda(
        "spmv_bsr_batch", M.data, M.slot_offsets, B, x,
        lanes=lane_group(M.shape[0], len(M.slot_offsets), B), batch=True,
    )
    LAUNCHES_K7_BATCH += 1
    return y
