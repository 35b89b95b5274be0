"""Sparse format layer: CSR / ELL / BSR / dense containers with padded nnz
(twin of ``openmg_tpu/ops/sparse.py``).

The general sparse engine (:mod:`openmg_tpu_torch.core.algebraic`) stores
its levels in these containers: frozen dataclasses of tensors on one
device, built once on the host from scipy.  Pad entries carry
``data == 0`` at a valid coordinate, so they are inert in every product.

* **ELL** in slot-major ``(k, n)`` layout.  A diagonal-structured matrix
  (the Poisson family, banded systems) is packed one slot per column offset
  and records ``slot_offsets``; its SpMV needs no column indices.
* **CSR** is the interchange format (row ids kept beside the columns).
* **BSR** in block-ELL layout; a block-banded matrix is stored slot-major
  ``(kb, bc, n)`` with ``slot_offsets``, so its SpMV needs no gather either.
* **Dense** is the debug mode of the original (``dense=True``).

:func:`spmv` dispatches by container: a square banded ELL goes to the
slot-offset kernel (:func:`openmg_tpu_torch.ops.ell.spmv_ell`, K6), a
banded BSR to the blocked-band kernel
(:func:`openmg_tpu_torch.ops.bsr.spmv_bsr`, K7); on a CUDA tensor each
launches its hand-written kernel or raises.  Everything else is tensor code
on any device, as it is array code outside any kernel in the JAX package:
the gather of an irregular or rectangular ELL (the transfer matrices), the
CSR product (``index_add_``), the general-BSR gather with ``einsum``, and
the dense product.  :func:`spmv_df`, the double-float product of the outer
residual, is tensor code built on the Dekker products of
:mod:`openmg_tpu_torch.ops.doublefloat`.

**A batch** ``(K, n)`` of vectors (``AlgebraicSolver.solve_many``): a
banded ELL level takes K6b and a banded BSR level K7b, one launch for the
batch, each member bit-equal to the scalar launch.  :func:`spmv_df` runs on
the stack: its products and sums are elementwise, so each member keeps the
scalar bits.  The other products go member by member through the scalar
code: the irregular ELL's and the CSR's reductions (``torch.sum`` over the
slots, ``index_add_``, which takes atomics on the card), the general BSR's
``einsum`` and the dense product are calls whose order of summation the
library may choose by the operands' shape, so a product over the batch need
not keep each member's bits.

Builders take ``device``: CUDA when None, and they raise when there is no
CUDA device (the package's device rule).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = [
    "CSRMatrix",
    "ELLMatrix",
    "BSRMatrix",
    "DenseMatrix",
    "csr_from_scipy",
    "ell_from_scipy",
    "bsr_from_scipy",
    "dense_from_scipy",
    "from_scipy",
    "to_scipy",
    "spmv",
    "spmv_df",
    "diagonal",
    "matvec_full",
    "full_float32",
]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _device(device) -> torch.device:
    from openmg_tpu_torch.core.solver import _resolve_device

    return _resolve_device(device)


def _put(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """CSR with padded nnz.

    ``data/indices/row_ids`` all have length ``nnz_pad``; entries are
    row-major sorted, pads sit at the end with ``data == 0`` in the last row.
    ``indptr`` is not kept on the device (the product uses ``row_ids``); it
    is rebuilt on the host in :func:`to_scipy`.
    """

    data: torch.Tensor  # (nnz_pad,)
    indices: torch.Tensor  # (nnz_pad,) int32 column of each entry
    row_ids: torch.Tensor  # (nnz_pad,) int32 row of each entry (sorted)
    shape: tuple  # (nrows, ncols)
    nnz: int  # true (unpadded) nnz

    @property
    def nnz_pad(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CSRMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK in slot-major layout: ``k`` entries per row stored as
    ``(k, nrows)`` planes; ``data[j, i]`` pairs with column ``cols[j, i]``;
    pad slots carry ``data == 0`` at column 0.

    **Invariant:** when ``slot_offsets`` is not None, every true entry of
    slot ``j`` satisfies ``cols[j, i] == i + slot_offsets[j]``.  The
    slot-offset kernel trusts ``slot_offsets`` and never reads ``cols``; the
    builders (:func:`ell_from_scipy`,
    :func:`openmg_tpu_torch.models.poisson.poisson_ell_device`) keep the
    invariant, and a hand-made instance must too.  ``slot_offsets=None``
    forces the gather.
    """

    data: torch.Tensor  # (k, nrows)
    cols: torch.Tensor  # (k, nrows) int32
    shape: tuple
    nnz: int
    bandwidth: int = 0  # max |col − row| over true entries
    slot_offsets: tuple | None = None

    @property
    def k(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "ELLMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block-sparse rows in block-ELL layout, in one of two layouts keyed on
    ``slot_offsets``:

    * ``None`` (general): ``data[I, J]`` is the dense ``(br, bc)`` block
      coupling block row ``I`` to block column ``bcols[I, J]``; pad slots
      are zero blocks at block column 0.
    * ``(d_0, …)`` (**blocked-band**): every true block of slot ``J`` sits
      at ``bcols[I, J] == I + d_J``, and ``data`` is slot-major
      ``(kb, bc, n)``: ``data[J, j, I·br + i]`` is element ``(i, j)`` of
      block ``(I, I + d_J)``.  ``bcols`` is kept for :func:`to_scipy`.

    ``nnz`` counts true scalar nonzeros.
    """

    data: torch.Tensor  # (nbrows, kb, br, bc) | banded: (kb, bc, n)
    bcols: torch.Tensor  # (nbrows, kb) int32
    shape: tuple
    blocksize: tuple  # (br, bc)
    nnz: int
    slot_offsets: tuple | None = None

    @property
    def kb(self) -> int:
        return int(
            self.data.shape[0] if self.slot_offsets is not None
            else self.data.shape[1]
        )

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "BSRMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operator (the original's ``dense=True`` debug mode); ``nnz``
    records the true sparse nonzero count."""

    data: torch.Tensor  # (nrows, ncols)
    nnz: int

    @property
    def shape(self) -> tuple:
        return tuple(int(s) for s in self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DenseMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))


# ---------------------------------------------------------------------------
# host-side conversion (setup time)
# ---------------------------------------------------------------------------


def dense_from_scipy(A, dtype=np.float32, device=None) -> DenseMatrix:
    """scipy sparse / numpy dense → :class:`DenseMatrix`."""
    import scipy.sparse as sp

    if sp.issparse(A):
        nnz = int(sp.csr_matrix(A).nnz)
        arr = A.toarray()
    else:
        arr = np.asarray(A)
        nnz = int(np.count_nonzero(arr))
    return DenseMatrix(data=_put(arr.astype(dtype), _device(device)), nnz=nnz)


def csr_from_scipy(A, pad_nnz_to: int = 8, dtype=np.float32, device=None) -> CSRMatrix:
    """scipy sparse → :class:`CSRMatrix`, nnz padded to a multiple of
    ``pad_nnz_to``."""
    import scipy.sparse as sp

    device = _device(device)
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    nnz = int(A.nnz)
    nnz_pad = max(_round_up(nnz, pad_nnz_to), pad_nnz_to)
    data = np.zeros(nnz_pad, dtype=dtype)
    indices = np.zeros(nnz_pad, dtype=np.int32)
    row_ids = np.full(nnz_pad, n - 1, dtype=np.int32)  # pads at end stay sorted
    data[:nnz] = A.data
    indices[:nnz] = A.indices
    row_ids[:nnz] = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(A.indptr).astype(np.int64)
    )
    return CSRMatrix(
        data=_put(data, device),
        indices=_put(indices, device),
        row_ids=_put(row_ids, device),
        shape=(int(n), int(m)),
        nnz=nnz,
    )


def ell_from_scipy(A, k: int | None = None, dtype=np.float32, device=None) -> ELLMatrix:
    """scipy sparse → :class:`ELLMatrix`; ``k`` defaults to the true
    max-nnz-per-row.

    A square matrix with few distinct ``col − row`` deltas (no more than
    the slot budget) is packed **one slot per offset**, so every slot is
    offset-regular and the slot-offset kernel takes it; other matrices use
    compact per-row packing (and keep ``slot_offsets`` when that happens to
    be offset-regular too).
    """
    import scipy.sparse as sp

    from openmg_tpu_torch.ops.ell import detect_slot_offsets

    device = _device(device)
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    counts = np.diff(A.indptr)
    k_true = int(counts.max()) if n else 0
    rows_of = np.repeat(np.arange(n), counts)
    bw = int(np.abs(A.indices - rows_of).max()) if A.nnz else 0

    # offset-aligned packing when the diagonal count fits the budget
    if n == m and A.nnz:
        deltas = np.unique(A.indices.astype(np.int64) - rows_of)
        k_dia = len(deltas)
        k_budget = k if k is not None else max(k_true, 1)
        if k_dia <= max(k_budget, k_true):
            kk = max(k_budget, k_dia, 1)
            data = np.zeros((kk, n), dtype=dtype)
            cols = np.zeros((kk, n), dtype=np.int32)
            offsets = [0] * kk
            Ad = sp.dia_matrix(A)
            diag_of = {int(d): Ad.data[i] for i, d in enumerate(Ad.offsets)}
            for j, d in enumerate(int(dd) for dd in deltas):
                # dia_matrix stores diagonal d at data[d:] (cols indexed)
                band = diag_of[d]
                r0, r1 = max(0, -d), min(n, n - d)
                rr = np.arange(r0, r1)
                data[j, rr] = band[rr + d]
                cols[j, rr] = rr + d
                offsets[j] = d
            return ELLMatrix(
                data=_put(data, device),
                cols=_put(cols, device),
                shape=(int(n), int(m)),
                nnz=int(A.nnz),
                bandwidth=bw,
                slot_offsets=tuple(offsets),
            )

    k = max(k if k is not None else k_true, 1)
    if k < k_true:
        raise ValueError(f"k={k} < max nnz/row {k_true}")
    data = np.zeros((k, n), dtype=dtype)
    cols = np.zeros((k, n), dtype=np.int32)
    # slot index of each entry within its row
    slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    data[slot, rows_of] = A.data
    cols[slot, rows_of] = A.indices
    return ELLMatrix(
        data=_put(data, device),
        cols=_put(cols, device),
        shape=(int(n), int(m)),
        nnz=int(A.nnz),
        bandwidth=bw,
        slot_offsets=detect_slot_offsets(data, cols) if n == m else None,
    )


def bsr_from_scipy(
    A, blocksize: tuple = (4, 4), kb: int | None = None, dtype=np.float32,
    device=None,
) -> BSRMatrix:
    """scipy sparse → :class:`BSRMatrix` (block-ELL).  Dims must divide by
    the block size; blocks are dense (explicit zeros inside a touched
    block)."""
    import scipy.sparse as sp

    device = _device(device)
    br, bc = int(blocksize[0]), int(blocksize[1])
    n, m = A.shape
    if n % br or m % bc:
        raise ValueError(f"shape {A.shape} not divisible by blocksize {blocksize}")
    true_nnz = int(sp.csr_matrix(A).nnz)
    B = sp.bsr_matrix(A, blocksize=(br, bc))
    B.sort_indices()
    nbr = n // br
    counts = np.diff(B.indptr)
    kb_true = int(counts.max()) if nbr else 0
    kb = max(kb if kb is not None else kb_true, 1)
    if kb < kb_true:
        raise ValueError(f"kb={kb} < max blocks/row {kb_true}")
    rows = np.repeat(np.arange(nbr), counts)

    # blocked-band packing (square blocks): one slot per block delta, so
    # every slot has a constant block-column delta; accepted with up to
    # about 50 % zero-block padding over compact packing
    if n == m and br == bc and B.indices.size:
        deltas_all = B.indices.astype(np.int64) - rows
        uniq = np.unique(deltas_all)
        kb_dia = len(uniq)
        if kb_dia <= max(kb, kb_true + max(kb_true // 2, 2)):
            kbb = max(kb, kb_dia, 1)
            slot_of = {int(d): s for s, d in enumerate(uniq)}
            s_idx = np.array([slot_of[int(d)] for d in deltas_all])
            data_sm = np.zeros((kbb, bc, nbr, br), dtype=dtype)
            # data_sm[s, j, I, i] = block[i, j]
            data_sm[s_idx, :, rows, :] = B.data.transpose(0, 2, 1)
            bcols = np.zeros((nbr, kbb), dtype=np.int32)
            bcols[rows, s_idx] = B.indices
            offs = [0] * kbb
            for s, d in enumerate(uniq):
                offs[s] = int(d)
            return BSRMatrix(
                data=_put(data_sm.reshape(kbb, bc, n), device),
                bcols=_put(bcols, device),
                shape=(int(n), int(m)),
                blocksize=(br, bc),
                nnz=true_nnz,
                slot_offsets=tuple(offs),
            )

    data = np.zeros((nbr, kb, br, bc), dtype=dtype)
    bcols = np.zeros((nbr, kb), dtype=np.int32)
    slot = np.arange(B.indices.size) - np.repeat(B.indptr[:-1], counts)
    data[rows, slot] = B.data
    bcols[rows, slot] = B.indices
    return BSRMatrix(
        data=_put(data, device),
        bcols=_put(bcols, device),
        shape=(int(n), int(m)),
        blocksize=(br, bc),
        nnz=true_nnz,
    )


def from_scipy(A, fmt: str = "ell", dtype=np.float32, device=None, **kw):
    """Dispatching converter: ``fmt`` in {"csr", "ell", "bsr", "dense"}."""
    if fmt == "csr":
        return csr_from_scipy(A, dtype=dtype, device=device, **kw)
    if fmt == "ell":
        return ell_from_scipy(A, dtype=dtype, device=device, **kw)
    if fmt == "bsr":
        return bsr_from_scipy(A, dtype=dtype, device=device, **kw)
    if fmt == "dense":
        return dense_from_scipy(A, dtype=dtype, device=device, **kw)
    raise ValueError(f"unknown sparse format {fmt!r}")


def _np(t):
    return t.detach().cpu().numpy()


def to_scipy(M):
    """Round-trip any container back to scipy CSR (drops padding)."""
    import scipy.sparse as sp

    if isinstance(M, CSRMatrix):
        rows = _np(M.row_ids)[: M.nnz]
        cols = _np(M.indices)[: M.nnz]
        vals = _np(M.data)[: M.nnz]
        return sp.coo_matrix((vals, (rows, cols)), shape=M.shape).tocsr()
    if isinstance(M, ELLMatrix):
        k, n = M.data.shape
        rows = np.tile(np.arange(n), k)
        cols = _np(M.cols).ravel()
        vals = _np(M.data).ravel()
        keep = vals != 0
        return sp.coo_matrix(
            (vals[keep], (rows[keep], cols[keep])), shape=M.shape
        ).tocsr()
    if isinstance(M, BSRMatrix):
        br, bc = M.blocksize
        nbr, kb = M.bcols.shape
        data = _np(M.data)
        if M.slot_offsets is not None:  # slot-major → canonical blocks
            data = data.reshape(kb, bc, nbr, br).transpose(2, 0, 3, 1)
        bcols = _np(M.bcols)
        indptr = np.arange(nbr + 1) * kb
        B = sp.bsr_matrix(
            (data.reshape(nbr * kb, br, bc), bcols.ravel(), indptr),
            shape=M.shape,
            blocksize=(br, bc),
        )
        out = sp.csr_matrix(B)
        out.eliminate_zeros()
        return out
    if isinstance(M, DenseMatrix):
        return sp.csr_matrix(_np(M.data))
    raise TypeError(f"not a sparse container: {type(M)}")


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_float32():
    """Products inside run in the operands' full precision: TF32 keeps about
    three decimal digits, which would cap a cycle's contraction.  False is
    PyTorch's default; it is set here so that a caller's global setting
    cannot change what the solver computes."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matvec_full(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in full precision (see :func:`full_float32`)."""
    with full_float32():
        return torch.matmul(A, x)


def spmv(M, x: torch.Tensor) -> torch.Tensor:
    """``y = M x`` for any container; ``x`` flat ``(ncols,)``, or a batch
    ``(K, ncols)`` (row k of the result ``M x[k]``; see the module's note).

    Pad entries contribute exactly 0 (zero data at valid coordinates)."""
    if x.ndim == 2:
        return _spmv_batch(M, x)
    if isinstance(M, ELLMatrix):
        from openmg_tpu_torch.ops import ell as _ell

        if _ell.supports(M) and x.dtype == M.dtype:
            return _ell.spmv_ell(M, x)
        return torch.sum(M.data * x[M.cols], dim=0)
    if isinstance(M, CSRMatrix):
        prod = M.data * x[M.indices]
        y = torch.zeros(M.shape[0], dtype=prod.dtype, device=prod.device)
        return y.index_add_(0, M.row_ids, prod)
    if isinstance(M, BSRMatrix):
        if M.slot_offsets is not None:
            from openmg_tpu_torch.ops import bsr as _bsr

            return _bsr.spmv_bsr(M, x)
        br, bc = M.blocksize
        xb = x.reshape(-1, bc)[M.bcols]  # (nbr, kb, bc)
        with full_float32():
            return torch.einsum("rkij,rkj->ri", M.data, xb).reshape(-1)
    if isinstance(M, DenseMatrix):
        return matvec_full(M.data, x)
    raise TypeError(f"not a sparse container: {type(M)}")


def _spmv_batch(M, x: torch.Tensor) -> torch.Tensor:
    """:func:`spmv` of a batch ``(K, ncols)``: K6b or K7b for a banded
    level, else the scalar product member by member."""
    if isinstance(M, ELLMatrix):
        from openmg_tpu_torch.ops import ell as _ell

        if _ell.supports(M) and x.dtype == M.dtype:
            return _ell.spmv_ell_batch(M, x)
    if isinstance(M, BSRMatrix) and M.slot_offsets is not None:
        from openmg_tpu_torch.ops import bsr as _bsr

        return _bsr.spmv_bsr_batch(M, x)
    return torch.stack([spmv(M, x[m]) for m in range(x.shape[0])])


def _shift_zero(v: torch.Tensor, d: int, H: int) -> torch.Tensor:
    """``w[i] = v[i + d]`` with zeros outside, through a vector padded by
    ``H ≥ |d|`` on both sides (the last axis; a batch's leading one is
    kept)."""
    return v[..., H + d: H + d + v.shape[-1] - 2 * H]


def spmv_df(M_hi, M_lo, x_hi, x_lo):
    """Double-float SpMV ``(A_hi + A_lo)(x_hi + x_lo)`` for the outer
    residual of the sparse engine (ELL only: the residual operator is
    stored in ELL whatever the cycle's format).

    Returns the pair ``(y_hi, y_lo)``.  Each slot's term goes through the
    compensated products and sums of :mod:`openmg_tpu_torch.ops.doublefloat`
    in slot order; a banded matrix reads shifted slices of the zero-padded
    vectors, any other gathers its columns.  The values are the same either
    way.  ``x_hi``/``x_lo`` may be a batch ``(K, n)``: every operation is
    elementwise, so each member has the bits of its scalar call.  Eager
    tensor code: never ``torch.compile`` it (``a*b − p`` must
    not be contracted).
    """
    from openmg_tpu_torch.ops.doublefloat import df_add, df_mul

    if not isinstance(M_hi, ELLMatrix):
        raise TypeError("spmv_df requires ELL residual operators")
    acc = None
    if M_hi.slot_offsets is not None:
        H = max((abs(int(d)) for d in M_hi.slot_offsets), default=0)
        xe_h = torch.nn.functional.pad(x_hi, (H, H)) if H else x_hi
        xe_l = torch.nn.functional.pad(x_lo, (H, H)) if H else x_lo
        for j, d in enumerate(M_hi.slot_offsets):
            xs = (_shift_zero(xe_h, int(d), H), _shift_zero(xe_l, int(d), H))
            term = df_mul((M_hi.data[j], M_lo.data[j]), xs)
            acc = term if acc is None else df_add(acc, term)
        return acc
    for j in range(M_hi.k):
        c = M_hi.cols[j]
        term = df_mul((M_hi.data[j], M_lo.data[j]), (x_hi[..., c], x_lo[..., c]))
        acc = term if acc is None else df_add(acc, term)
    return acc


def diagonal(M) -> torch.Tensor:
    """Main diagonal of a (square) container, computed on its device."""
    n = M.shape[0]
    if isinstance(M, ELLMatrix):
        rows = torch.arange(n, dtype=M.cols.dtype, device=M.cols.device)[None, :]
        return torch.sum(torch.where(M.cols == rows, M.data, 0.0), dim=0)
    if isinstance(M, CSRMatrix):
        hit = torch.where(M.indices == M.row_ids, M.data, 0.0)
        y = torch.zeros(n, dtype=M.dtype, device=M.data.device)
        return y.index_add_(0, M.row_ids, hit)
    if isinstance(M, BSRMatrix):
        br, bc = M.blocksize
        dev = M.data.device
        if M.slot_offsets is not None:
            # diag[r] = Σ_{slots with d=0} data[s, r % B, r]
            rmod = (torch.arange(n, dtype=torch.int64, device=dev) % br)[None, :]
            diag = torch.zeros(n, dtype=M.dtype, device=dev)
            for s, d in enumerate(M.slot_offsets):
                if d != 0:
                    continue
                diag = diag + torch.gather(M.data[s], 0, rmod)[0]
            return diag
        nbr = n // br
        rows = torch.arange(nbr, dtype=M.bcols.dtype, device=dev)[:, None]
        dia_blocks = torch.sum(
            torch.where((M.bcols == rows)[:, :, None, None], M.data, 0.0),
            dim=1,
        )  # (nbr, br, bc)
        idx = torch.arange(min(br, bc), device=dev)
        return dia_blocks[:, idx, idx].reshape(-1)
    if isinstance(M, DenseMatrix):
        return torch.diagonal(M.data).clone()
    raise TypeError(f"not a sparse container: {type(M)}")
