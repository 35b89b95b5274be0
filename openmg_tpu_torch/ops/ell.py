"""Slot-offset ELL SpMV, kernel K6 (twin of ``openmg_tpu/ops/ell.py``).

A square ELL matrix whose every slot has one constant column offset
(``cols[j, i] == i + d_j`` wherever ``data[j, i] != 0``; the Poisson family,
banded matrices, any matrix packed one slot per diagonal) multiplies as

    y[i] = Σ_j data[j, i] · x[i + d_j]          (x outside [0, n) is 0)

with no column indices read at all.  :func:`spmv_ell` dispatches on the
device of ``x``: a CUDA tensor launches the hand-written kernel
``csrc/spmv_banded.cu`` (float32 or float64) or raises; a CPU tensor runs
the plain version :func:`spmv_banded_plain`, which sums the slots in the
same order, so the two agree bit for bit.  ``LAUNCHES_K6`` counts the
launches.  The kernel is the blocked-band BSR kernel (K7,
:mod:`openmg_tpu_torch.ops.bsr`) at block size 1, and
:func:`spmv_banded_cuda` is the one launch of both.

K6b (:func:`spmv_ell_batch`, the JAX module's kernel under ``jax.vmap``)
is its batched form: ``(K, n)`` vectors through one matrix in one launch,
the matrix read once for up to eight members, each member's sum in the
scalar slot order, so it equals the scalar launch bit for bit; its plain
version :func:`spmv_banded_batch_plain` is the scalar plain version member
by member.  ``LAUNCHES_K6_BATCH`` counts its launches.

K6h (:func:`spmv_banded_halo`) is its halo form on a rank's slab of rows
of the distributed sparse engine (:mod:`openmg_tpu_torch.parallel.
sparse_dist`): the same sum over the slab's ``m`` rows with ``x`` extended
by the ``H`` rows received from each neighbour, read in place by the
kernel.  ``LAUNCHES_K6H`` counts its launches.  K6hb
(:func:`spmv_banded_halo_batch`) is K6h on a batch: ``(K, m)`` slabs, each
member's ``(K, H)`` received rows its own, one launch with the batched
form's eight members a thread, each member bit-equal to K6h on it;
``LAUNCHES_K6H_BATCH`` counts its launches.

The JAX package's tile-height and VMEM rules (``pick_tile_rows``), its size
gate (``prefer_kernel``) and its lane shifts (``_shift_rows``) are that
hardware's and are not copied: :func:`supports` asks only for a square,
floating matrix with ``slot_offsets``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = [
    "LAUNCHES_K6",
    "LAUNCHES_K6_BATCH",
    "detect_slot_offsets",
    "supports",
    "spmv_banded_plain",
    "spmv_ell",
    "spmv_banded_batch_plain",
    "spmv_ell_batch",
    "offsets_tensor",
    "check_operands",
    "spmv_banded_cuda",
    "LAUNCHES_K6H",
    "LAUNCHES_K6H_BATCH",
    "band_halo",
    "spmv_banded_halo_plain",
    "spmv_banded_halo",
    "spmv_banded_halo_batch_plain",
    "spmv_banded_halo_batch",
]

# launches of the slot-offset ELL kernel (K6), of its halo form (K6h), of
# its batched form (K6b: K vectors a launch) and of the halo form on a batch
# (K6hb)
LAUNCHES_K6 = 0
LAUNCHES_K6H = 0
LAUNCHES_K6_BATCH = 0
LAUNCHES_K6H_BATCH = 0


def detect_slot_offsets(data, cols):
    """Per-slot constant column delta, or None if any slot is irregular.

    Host-side (numpy), setup time.  ``data``/``cols`` are the slot-major
    ``(k, n)`` arrays; entries with ``data == 0`` (pads and boundary
    truncations) are ignored.
    """
    data = np.asarray(data)
    cols = np.asarray(cols)
    k, n = data.shape
    rows = np.arange(n, dtype=np.int64)
    offsets = []
    for j in range(k):
        mask = data[j] != 0
        if not mask.any():
            offsets.append(0)
            continue
        deltas = cols[j][mask].astype(np.int64) - rows[mask]
        d0 = int(deltas[0])
        if not (deltas == d0).all():
            return None
        offsets.append(d0)
    return tuple(offsets)


def supports(M) -> bool:
    """Whether :func:`spmv_ell` takes ``M``: square, floating, and every
    slot offset-regular."""
    n, m = M.shape
    return n == m and M.data.is_floating_point() and M.slot_offsets is not None


def spmv_banded_plain(data, slot_offsets, x):
    """Plain PyTorch version of K6: ``y = Σ_j data[j] ⊙ x[· + d_j]`` with
    zeros outside the vector, summed in slot order."""
    n = x.shape[0]
    H = max((abs(int(d)) for d in slot_offsets), default=0)
    xe = torch.nn.functional.pad(x, (H, H)) if H else x
    acc = None
    for j, d in enumerate(slot_offsets):
        t = data[j] * xe[H + int(d): H + int(d) + n]
        acc = t if acc is None else acc + t
    return acc


_fn = None
_fn_halo = None
_offsets_on = {}  # (slot offsets, device) -> int32 tensor of the offsets
_offsets_host = {}  # slot offsets -> ctypes int array of them (by value)


def _kernel():
    global _fn
    if _fn is None:
        from openmg_tpu_torch import _build

        fn = _build.load().omg_spmv_banded
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # data, offs (host), offs (device), k, B, lanes, x, y, n, members,
        # dbl, stream
        fn.argtypes = [p, p, p, i, i, i, p, p, ll, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _kernel_halo():
    global _fn_halo
    if _fn_halo is None:
        from openmg_tpu_torch import _build

        fn = _build.load().omg_spmv_banded_halo
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # data, offs (host), offs (device), k, x, lo, hi, H, y, m, members,
        # dbl, stream
        fn.argtypes = [p, p, p, i, p, p, p, ll, p, ll, i, i, p]
        fn.restype = i
        _fn_halo = fn
    return _fn_halo


def _host_offsets(slot_offsets):
    """The slot offsets as a ctypes int array (by value to the kernel),
    made once per offset tuple."""
    key = tuple(int(d) for d in slot_offsets)
    host = _offsets_host.get(key)
    if host is None:
        host = _offsets_host[key] = (ctypes.c_int * len(key))(*key)
    return host


def offsets_tensor(offsets, device) -> torch.Tensor:
    """The slot offsets as an int32 tensor on ``device``, made once per
    offset tuple and device (a level's offsets never change)."""
    key = (tuple(int(d) for d in offsets), str(device))
    t = _offsets_on.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=torch.int32, device=device)
        _offsets_on[key] = t
    return t


def check_operands(what, data, x, kernel_rows, batch=False):
    """Raise unless ``data`` and ``x`` are what the kernels take: one CUDA
    device, float32 or float64 alike, contiguous, and ``x`` of length
    ``kernel_rows`` (with ``batch``, ``x`` ``(K, kernel_rows)``)."""
    if data.dtype not in (torch.float32, torch.float64) or x.dtype != data.dtype:
        raise ValueError(
            f"{what} takes float32 or float64 operands of one type, got "
            f"{data.dtype} and {x.dtype}"
        )
    if data.device != x.device:
        raise ValueError(f"{what}: operands on {data.device} and {x.device}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{what} takes contiguous operands")
    if x.ndim != 1 + int(batch) or x.shape[-1] != kernel_rows or x.shape[0] < 1:
        want = f"(K, {kernel_rows})" if batch else f"({kernel_rows},)"
        raise ValueError(f"{what}: x has shape {tuple(x.shape)}, expected {want}")


def spmv_banded_cuda(what, data, slot_offsets, B, x, lanes=1, batch=False):
    """One launch of ``csrc/spmv_banded.cu`` on CUDA tensors:
    ``y[I·B + i] = Σ_j Σ_s data[s, j, I·B + i] · x[(I + d_s)·B + j]`` for
    ``data`` of shape ``(k, B, n)``, or ``(k, n)`` when ``B`` is 1 (ELL),
    a row's terms split over ``lanes`` lanes (see
    :func:`openmg_tpu_torch.ops.bsr.lane_group`; 1 for ELL); with
    ``batch``, ``x`` and ``y`` ``(K, n)``, one launch for all K.  Raises on
    operands the kernel does not take, an output that would alias ``x``, or
    a failed launch."""
    n = x.shape[-1] if x.ndim == 1 + int(batch) else data.shape[-1]
    k = len(slot_offsets)
    check_operands(what, data, x, n, batch)
    want = (k, n) if B == 1 and data.ndim == 2 else (k, B, n)
    if B < 1 or n % B or tuple(data.shape) != want:
        raise ValueError(
            f"{what}: data {tuple(data.shape)} and {k} slot offsets for {n} "
            f"rows in blocks of {B}"
        )
    dev = x.device
    offs = offsets_tensor(slot_offsets, dev)
    host = _host_offsets(slot_offsets)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            data.data_ptr(), host, offs.data_ptr(), k, B, lanes, x.data_ptr(),
            y.data_ptr(), n, x.shape[0] if batch else 1,
            int(x.dtype == torch.float64), stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_spmv_banded failed with code {rc}")
    return y


def spmv_ell(M, x):
    """``y = M x`` for a slot-offset ELL matrix (see :func:`supports`), by
    the device of ``x``: the CUDA kernel on the card, the plain version on
    the CPU."""
    global LAUNCHES_K6
    if not supports(M):
        raise ValueError(
            "spmv_ell takes a square floating ELL matrix with slot_offsets"
        )
    if x.device.type == "cpu":
        return spmv_banded_plain(M.data, M.slot_offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = spmv_banded_cuda("spmv_ell", M.data, M.slot_offsets, 1, x)
    LAUNCHES_K6 += 1
    return y


def spmv_banded_batch_plain(data, slot_offsets, x):
    """Plain version of K6b: :func:`spmv_banded_plain` on each row of the
    ``(K, n)`` ``x``, stacked."""
    return torch.stack([spmv_banded_plain(data, slot_offsets, x[m])
                        for m in range(x.shape[0])])


def spmv_ell_batch(M, x):
    """K6b: ``Y = X Mᵀ``, row k of ``y`` ``M x[k]``, for a slot-offset ELL
    matrix and ``(K, n)`` vectors, by the device of ``x``: one launch of the
    CUDA kernel for all K on the card, each row bit-equal to
    :func:`spmv_ell` of it; the plain version on the CPU."""
    global LAUNCHES_K6_BATCH
    if not supports(M):
        raise ValueError(
            "spmv_ell_batch takes a square floating ELL matrix with slot_offsets"
        )
    if x.ndim != 2:
        raise ValueError(f"spmv_ell_batch: x has shape {tuple(x.shape)}, not (K, n)")
    if x.device.type == "cpu":
        return spmv_banded_batch_plain(M.data, M.slot_offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    y = spmv_banded_cuda("spmv_ell_batch", M.data, M.slot_offsets, 1, x,
                         batch=True)
    LAUNCHES_K6_BATCH += 1
    return y


def band_halo(slot_offsets) -> int:
    """``H = max |d_j|``: the rows a banded row reaches across a slab edge."""
    return max((abs(int(d)) for d in slot_offsets), default=0)


def spmv_banded_halo_plain(data, slot_offsets, x, lo, hi):
    """Plain PyTorch version of K6h: ``y = Σ_j data[j] ⊙ xe[H + d_j : H +
    d_j + m]`` with ``xe = [lo | x | hi]``, summed in slot order (the
    shifted slices of the JAX package's ``_spmv_banded_local``).  Its rows
    equal :func:`spmv_banded_plain`'s rows of the whole vector bit for
    bit."""
    H, m = lo.shape[0], x.shape[0]
    xe = torch.cat([lo, x, hi]) if H else x
    acc = None
    for j, d in enumerate(slot_offsets):
        t = data[j] * xe[H + int(d): H + int(d) + m]
        acc = t if acc is None else acc + t
    return acc


def check_halo_operands(data, slot_offsets, x, lo, hi, batch=False):
    """Raise unless ``data`` ``(k, m)``, ``x`` ``(m,)`` and the received
    rows ``lo``, ``hi`` ``(H,)`` are what K6h takes (with ``batch``, K6hb:
    ``x`` ``(K, m)``, ``lo`` and ``hi`` ``(K, H)``): float32 or float64
    alike, one device, contiguous, ``k`` slot offsets none beyond ``H``."""
    what = "spmv_banded_halo_batch" if batch else "spmv_banded_halo"
    ts = (data, x, lo, hi)
    if data.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != data.dtype for t in ts):
        raise ValueError(
            f"{what} takes float32 or float64 operands of one type, got "
            f"{[str(t.dtype) for t in ts]}"
        )
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{what}: operands on {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous operands")
    nd = 1 + int(batch)
    if x.ndim != nd or lo.ndim != nd or hi.ndim != nd or lo.shape != hi.shape \
            or lo.shape[:-1] != x.shape[:-1] or x.shape[0] < 1:
        each = " a member" if batch else ""
        raise ValueError(
            f"{what}: x {tuple(x.shape)}, lo {tuple(lo.shape)}, hi "
            f"{tuple(hi.shape)}: a slab and two halos of H rows{each}"
        )
    m, H, k = x.shape[-1], lo.shape[-1], len(slot_offsets)
    if tuple(data.shape) != (k, m):
        raise ValueError(
            f"{what}: data {tuple(data.shape)} for {k} slot offsets and {m} rows"
        )
    if band_halo(slot_offsets) > H:
        raise ValueError(
            f"{what}: slot offsets reach {band_halo(slot_offsets)} rows, the "
            f"halos hold {H}"
        )


def spmv_banded_halo(data, slot_offsets, x, lo, hi):
    """K6h: ``y = A_slab x`` on a rank's ``m`` rows of a banded ELL level
    (``data`` its slot planes' columns ``(k, m)``), ``lo``/``hi`` the ``H``
    rows received from the rank below / above (zeros at the domain's edges),
    by the device of ``x``: the CUDA kernel on the card (``x`` is never
    concatenated with its halos there), the plain version on the CPU."""
    global LAUNCHES_K6H
    check_halo_operands(data, slot_offsets, x, lo, hi)
    if x.device.type == "cpu":
        return spmv_banded_halo_plain(data, slot_offsets, x, lo, hi)
    y = _halo_cuda(data, slot_offsets, x, lo, hi, 1)
    LAUNCHES_K6H += 1
    return y


def _halo_cuda(data, slot_offsets, x, lo, hi, members):
    """One launch of ``omg_spmv_banded_halo`` on checked operands."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    offs = offsets_tensor(slot_offsets, dev)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_halo()(
            data.data_ptr(), _host_offsets(slot_offsets), offs.data_ptr(),
            len(slot_offsets), x.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            lo.shape[-1], y.data_ptr(), x.shape[-1], members,
            int(x.dtype == torch.float64), stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_spmv_banded_halo failed with code {rc}")
    return y


def spmv_banded_halo_batch_plain(data, slot_offsets, x, lo, hi):
    """Plain version of K6hb: :func:`spmv_banded_halo_plain` on each member
    of the ``(K, m)`` slabs with its ``(K, H)`` received rows, stacked."""
    return torch.stack([spmv_banded_halo_plain(data, slot_offsets, x[m], lo[m], hi[m])
                        for m in range(x.shape[0])])


def spmv_banded_halo_batch(data, slot_offsets, x, lo, hi):
    """K6hb: :func:`spmv_banded_halo` on K members of a rank's rows at once,
    ``x`` ``(K, m)`` and each member's received rows ``lo`` / ``hi`` ``(K,
    H)``, the slot planes shared: one launch on the card, each member
    bit-equal to K6h on it; the plain version on the CPU."""
    global LAUNCHES_K6H_BATCH
    check_halo_operands(data, slot_offsets, x, lo, hi, batch=True)
    if x.device.type == "cpu":
        return spmv_banded_halo_batch_plain(data, slot_offsets, x, lo, hi)
    y = _halo_cuda(data, slot_offsets, x, lo, hi, x.shape[0])
    LAUNCHES_K6H_BATCH += 1
    return y
