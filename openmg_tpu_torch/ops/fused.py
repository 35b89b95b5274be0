"""Fused V-cycle level visits (twin of ``openmg_tpu/ops/fused.py``).

One call does everything a level visit of the V-cycle needs from the
smoother: S stages (weighted-Jacobi steps or red/black half-sweeps) of a
constant or cornered radius-1 3D (or 2D) stencil, optionally from a zero start
(only ``b`` is read), optionally from ``x + P·ec`` (the prolongation is
never stored), optionally followed by the residual ``b − A x`` or by its
restriction ``bc = R (b − A x)`` (the fine residual is never stored).

:func:`fused_stages_const_3d` dispatches on the device of ``b`` alone:

* a CUDA tensor launches the hand-written kernel
  (``csrc/fused_stages.cu``, built on first use by
  :mod:`openmg_tpu_torch._build`) or raises;
* a CPU tensor runs :func:`fused_stages_const_3d_plain`, whole-grid tensor
  code stage by stage.  The tests and the on-card comparison of
  ``chip_smoke.py`` use it; nothing on the main path does when the tensors
  are on the card.

``LAUNCHES`` counts the kernel's launches.  A call whose depth (stages, +1
with a residual, +1 more with a restriction) is at most ``MAX_DEPTH`` is
one launch: the whole visit runs in one pass over the grid.  A deeper call
is split by :func:`depth_chunks` into ``⌈depth / MAX_DEPTH⌉`` consecutive
launches of the same kernel (on the CPU, into as many calls of the plain
version, which give the same values as one whole call).

**The halo form** (``halos=``, the row-partitioned tier of
:mod:`openmg_tpu_torch.parallel.fast`): a visit on a rank's z-slab with
D-deep slabs of ``b`` and ``x`` (and of the coarse ``ec``) received from the
ranks below and above, and the flags ``(open_lo, open_hi)`` that say which
edges have a neighbour.  The kernel walks the received planes as the
planes past the slab's edges (its marching shape already recomputes a
D-deep halo at every chunk's edge; the resident shape declines halos), so
the slab's own planes come out as the whole grid's rows would.  A
cornered level's axis-0 regions lie on the first rank only
(:func:`gate_corner`).  Its plain version runs the whole-grid plain
version on the slab extended by the received planes and slices it.
Halo launches count apart, in ``LAUNCHES_HALO``.

**The batched form** (K1b, the JAX package's kernel under ``jax.vmap``):
:func:`fused_stages_const_3d_batch` takes K members of one level stacked
along a leading axis and runs a visit of all of them in one launch (one
operator, stage list and transfer), each member bit-equal to the scalar
launch on it; its plain version :func:`fused_stages_const_3d_batch_plain`
is the scalar plain version member by member.  Batch launches count apart,
in ``LAUNCHES_BATCH``; :func:`last_shape` says which shape the C side took.

**The halo form on a batch** (K1hb, the halo kernel under ``jax.vmap``):
:func:`fused_stages_const_3d_batch` with ``halos=`` runs a visit of K
members of a rank's slab in one launch, every member with its own received
slabs stacked like its grids (``(K, D, ny, nx)`` of ``b`` and ``x``, ``(K,
D/2 (+1), ny/2, nx/2)`` of ``ec``), the flags shared; marching shape only,
as the halo form.  Its plain version is the scalar halo form's member by
member.  Its launches count in ``LAUNCHES_HALO_BATCH``.

The entry points (:func:`smooth_fused`, :func:`presmooth_residual_fused`,
:func:`presmooth_restrict_fused`, :func:`residual_restrict_fused`,
:func:`prolong_smooth_fused`) keep the JAX package's signatures.  A 2D
operand goes to :func:`_fused2d`, the JAX package's 2D branch: all stages of
the visit in one call of :func:`openmg_tpu_torch.ops.kernels.fused_stages_2d`
(K5, ``csrc/fused_stages_2d.cu``).  They return None only for what the
kernels truly do not take: not 2D or 3D, not float32, a stencil of radius
> 1, a smoother that is not a list of stages, an odd dimension with a
transfer, and in 2D a visit with no stages or a stage-free residual with
restriction (as in the JAX package).  Each also takes a batch ``(K,
*grid)`` of the operator's grids (K1b or K5b), decided by the operator's
dimension.  The JAX package's fit models, lane
rules and 2D plane-size gate describe its own hardware's memory and are not
copied.
"""

from __future__ import annotations

import ctypes

import torch

from openmg_tpu_torch.ops.stencil import CorneredOperator, diag_index, shift
from openmg_tpu_torch.ops.transfer import prolong, restrict

__all__ = [
    "LAUNCHES",
    "LAUNCHES_HALO",
    "LAUNCHES_BATCH",
    "LAUNCHES_HALO_BATCH",
    "fused_stages_const_3d_batch",
    "fused_stages_const_3d_batch_plain",
    "gate_corner",
    "halo_depth",
    "MAX_DEPTH",
    "depth_chunks",
    "stages_for",
    "fused_stages_const_3d",
    "fused_stages_const_3d_plain",
    "smooth_fused",
    "presmooth_residual_fused",
    "presmooth_restrict_fused",
    "prolong_smooth_fused",
    "residual_restrict_fused",
]

# launches of the CUDA kernel (one a call up to MAX_DEPTH)
LAUNCHES = 0
# ... of its halo form (a rank's slab with received planes)
LAUNCHES_HALO = 0
# ... of its batched form (K members of one level a launch)
LAUNCHES_BATCH = 0
# ... of its halo form on a batch (K members of a rank's slab a launch)
LAUNCHES_HALO_BATCH = 0
# the deepest visit one launch of csrc/fused_stages.cu takes (stages, +1
# with a residual, +1 more with a restriction); its MAX_DEPTH
MAX_DEPTH = 6

_KIND_CODE = {"jacobi": 0, "rb": 1}


def stages_for(name: str, iterations: int, omega: float):
    """Half-sweep stage list for a smoother, or None if not stage-fusable."""
    if name == "jacobi":
        return (("jacobi", float(omega)),) * iterations
    if name == "rbgs":
        return (("rb", 0), ("rb", 1)) * iterations
    return None


def depth_chunks(stages, extra, max_depth):
    """Split a visit whose depth (stages + ``extra`` residual levels) is more
    than ``max_depth`` into consecutive chunks of at most ``max_depth``
    stages; only the last one carries the ``extra`` levels, so a visit of
    depth d takes ``⌈d / max_depth⌉`` chunks."""
    chunks, rest = [], tuple(stages)
    while len(rest) + extra > max_depth:
        chunks.append(rest[:max_depth])
        rest = rest[max_depth:]
    return chunks + [rest]


def _norm_stages(stages):
    return tuple(
        (str(k), (float(p) if k == "jacobi" else int(p))) for k, p in stages
    )


def _axis_weights(taps):
    """Weights of taps −1, 0, +1 (0.0 where the transfer has no such tap),
    or None for taps of radius > 1."""
    w = {-1: 0.0, 0: 0.0, 1: 0.0}
    for t, v in taps:
        if t not in w:
            return None
        w[t] += float(v)
    return (w[-1], w[0], w[1])


_KEEP_INDEX = {}


def gate_corner(corner, open_lo):
    """A cornered operator's ``(regions, table)`` as a rank's slab sees
    it: with a neighbour below (``open_lo``) the slab's plane 0 is not the
    grid's, so the regions on axis 0 are dropped (a point there takes the
    row of its other zero coordinates); the first rank keeps them all.

    The rows kept are selected on the table's device by an index made once
    per device and reused: a host list copied to the card at every call
    would wait for the stream (a copy from pageable memory) and hold each
    gated pass to the host's pace."""
    if not corner or not open_lo:
        return corner
    regions, table = corner
    keep = tuple(r for r, R in enumerate(regions) if 0 not in R)
    if not keep:
        return None
    key = (keep, table.device)
    idx = _KEEP_INDEX.get(key)
    if idx is None:
        idx = _KEEP_INDEX[key] = torch.tensor(keep, device=table.device)
    return tuple(regions[r] for r in keep), table.index_select(0, idx)


def halo_depth(n_stages: int, emit_residual: bool, restrict: bool, ec: bool) -> int:
    """The planes of ``b`` and ``x`` a halo visit needs from each
    neighbour: its depth (stages, +1 with a residual, +1 more with a
    restriction), rounded up to even with a prolongation (the coarse slabs
    are then ``depth // 2`` below and ``depth // 2 + 1`` above), as in the
    JAX package."""
    d = n_stages + int(bool(emit_residual)) + int(bool(restrict))
    return d + d % 2 if ec else d


def _row_map(corner):
    """For each mask of zero coordinates (bit a set: coordinate a is 0) the
    row of the region table a point uses, −1 for the interior values."""
    if not corner:
        return (-1,) * 8
    regions = tuple(tuple(R) for R in corner[0])
    face_axes = sorted({a for R in regions for a in R})
    out = []
    for m in range(8):
        R = tuple(a for a in face_axes if m >> a & 1)
        out.append(regions.index(R) if R else -1)
    return tuple(out)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _tap_field(values, offsets, corner, k, shape):
    """Tap of offset k at every point: the interior value, overwritten on
    the low faces/edges/corner by the region table (ascending regions, so
    the deepest region a point lies in wins).  A 0-d tensor for a constant
    operator."""
    if not corner:
        return values[k]
    regions, tbl = corner
    f = torch.zeros(shape, dtype=values.dtype, device=values.device) + values[k]
    for r, R in enumerate(regions):
        idx = tuple(
            slice(0, 1) if a in R else slice(None) for a in range(len(shape))
        )
        f[idx] = tbl[r, k]
    return f


def _halo_plain(values, offsets, b, x, stages, emit_residual, corner,
                restrict_transfer, ec, prolong_transfer, emit_x, halos):
    """The halo form's plain version: the whole-grid plain version on the
    slab extended at each open edge by the received slabs (and one zero
    plane where their depth is odd, so the extension is even: the colours
    and the coarse planes stay aligned), then the slab's own rows.  A
    plane of the extension that the received slabs do not reach is wrong
    after the visit's levels, but no output depends on it."""
    (open_lo, open_hi), b_pair, x_pair, ec_pair = halos
    nz = b.shape[0]

    def pad_of(depth, cdepth, is_open):
        if not is_open:
            return 0
        p = depth + depth % 2
        return max(p, 2 * cdepth)

    def ext(t, pair, plo, phi):
        z = lambda n: torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,  # noqa: E731
                                  device=t.device)
        lo, hi = pair if pair is not None else (z(0), z(0))
        lo = lo[max(0, lo.shape[0] - plo):]
        hi = hi[:phi]
        return torch.cat([z(plo - lo.shape[0]), lo, t, hi, z(phi - hi.shape[0])], 0)

    hd = b_pair[0].shape[0]
    clo = ec_pair[0].shape[0] if ec_pair is not None else 0
    chi = ec_pair[1].shape[0] if ec_pair is not None else 0
    plo = pad_of(hd, clo, open_lo)
    phi = pad_of(hd, 0, open_hi)
    if ec is not None and open_hi:
        # the odd plane at the top of the extension reads the coarse plane
        # above it: two more (zero) fine planes make room for it
        phi += 2
    b_e = ext(b, b_pair, plo, phi)
    x_e = None if x is None else ext(x, x_pair, plo, phi)
    ec_e = None
    if ec is not None:
        ec_e = ext(ec, ec_pair, plo // 2, phi // 2)
    out = fused_stages_const_3d_plain(
        values, offsets, b_e, x_e, stages, emit_residual, corner,
        restrict_transfer, ec_e, prolong_transfer, emit_x,
    )
    own = lambda t: t[plo: plo + nz]  # noqa: E731
    if not emit_residual:
        return own(out)
    r = out if not emit_x else out[1]
    r = r[plo // 2: plo // 2 + nz // 2] if restrict_transfer is not None else own(r)
    if not emit_x:
        return r
    return own(out[0]), r


def fused_stages_const_3d_plain(
    values, offsets, b, x, stages, emit_residual: bool = False,
    corner=None, restrict_transfer=None, ec=None, prolong_transfer=None,
    emit_x: bool = True, halos=None,
):
    """Plain PyTorch version of :func:`fused_stages_const_3d`: the same
    function in whole-grid tensor operations, one stage after the other.

    Follows the kernel's arithmetic: taps summed in the order of
    ``offsets``; interior points multiply by the reciprocal of the
    interior diagonal, region points divide by their own diagonal.  Not bit
    for bit the kernel (which may fuse multiply-adds), but within a few ulp.
    ``halos``: as in :func:`fused_stages_const_3d` (``corner`` already
    gated for the slab).
    """
    if halos is not None:
        return _halo_plain(values, offsets, b, x, stages, emit_residual, corner,
                           restrict_transfer, ec, prolong_transfer, emit_x, halos)
    offsets = tuple(tuple(o) for o in offsets)
    stages = _norm_stages(stages)
    shape = tuple(b.shape)
    di = diag_index(offsets)
    fields = [_tap_field(values, offsets, corner, k, shape) for k in range(len(offsets))]
    inv_d = 1.0 / values[di]
    if corner:
        regions = corner[0]
        in_region = torch.zeros(shape, dtype=torch.bool, device=b.device)
        for R in regions:
            idx = tuple(
                slice(0, 1) if a in R else slice(None) for a in range(3)
            )
            in_region[idx] = True
    else:
        in_region = None

    def acc_of(X, skip_diag):
        acc = None
        for k, off in enumerate(offsets):
            if skip_diag and k == di:
                continue
            term = fields[k] * shift(X, off)
            acc = term if acc is None else acc + term
        if acc is None:  # diagonal-only operator, diagonal skipped
            acc = torch.zeros_like(X)
        return acc

    X = torch.zeros_like(b) if x is None else x
    if ec is not None:
        X = X + prolong(ec, shape, prolong_transfer)

    par = None
    for kind, p in stages:
        if kind == "jacobi":
            res = b - acc_of(X, False)
            Xn = X + p * (inv_d * res)
            if in_region is not None:
                Xn = torch.where(in_region, X + (p * res) / fields[di], Xn)
        elif kind == "rb":
            res = b - acc_of(X, True)
            xn = inv_d * res
            if in_region is not None:
                xn = torch.where(in_region, res / fields[di], xn)
            if par is None:
                iz = torch.arange(shape[0], device=b.device).view(-1, 1, 1)
                iy = torch.arange(shape[1], device=b.device).view(1, -1, 1)
                ix = torch.arange(shape[2], device=b.device).view(1, 1, -1)
                par = (iz + iy + ix) & 1
            Xn = torch.where(par == p, xn, X)
        else:
            raise ValueError(f"unknown stage kind {kind!r}")
        X = Xn

    if not emit_residual:
        return X
    r = b - acc_of(X, False)
    if restrict_transfer is not None:
        r = restrict(r, restrict_transfer)
    if not emit_x:
        return r
    return X, r


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from openmg_tpu_torch import _build

        lib = _build.load()
        fn = lib.omg_fused_stages
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [
            p, p, p, i, p,        # values, table, offs, K, rowmap
            p, p, p,              # b, x, ec
            p, p,                 # x_out, r_out
            i, i, i,              # nz, ny, nx
            i, p, p, i,           # n_stages, kinds, pars, emit_residual
            p, p,                 # rw, pw
            p, p, p, p, p, p,     # halo slabs: b lo/hi, x lo/hi, ec lo/hi
            i, i, i, i, i, i,     # open_lo, open_hi, planes of b/x lo, hi, ec lo, hi
            i, p,                 # members of a batch, stream
        ]
        fn.restype = i
        depth = lib.omg_fused_max_depth
        depth.restype = i
        if depth() != MAX_DEPTH:
            raise RuntimeError(
                f"csrc/fused_stages.cu takes visits of depth {depth()}, "
                f"the wrapper splits at {MAX_DEPTH}"
            )
        _fn = fn
    return _fn


def last_shape() -> str:
    """The shape the last launch of ``csrc/fused_stages.cu`` took:
    ``"resident"`` or ``"marching"`` (the C side chooses by the fit)."""
    from openmg_tpu_torch import _build

    fn = _build.load().omg_fused_last_shape
    fn.restype = ctypes.c_int
    return {1: "resident", 0: "marching"}.get(fn(), "none")


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _transfer_weights(shape, device, restrict_transfer, ec, prolong_transfer,
                      lead=()):
    """The kernels' ``(rw, pw)``: weights of taps −1, 0, +1 of the
    restriction and of the prolongation (zeros for one not asked for),
    after checking what the in-kernel transfers take.  ``shape`` is the
    grid's; ``lead`` the batch's leading axis, ``(K,)``, or ``()``."""
    rw = pw = (0.0, 0.0, 0.0)
    if restrict_transfer is not None:
        rw = _axis_weights(restrict_transfer.r_taps)
    if ec is not None:
        if prolong_transfer is None:
            raise ValueError("ec needs prolong_transfer")
        pw = _axis_weights(prolong_transfer.p_taps)
        _check("ec", ec, tuple(lead) + tuple(s // 2 for s in shape), device)
    if rw is None or pw is None:
        raise ValueError("the kernel takes transfer taps of radius 1 only")
    if (restrict_transfer is not None or ec is not None) and any(
        s % 2 for s in shape
    ):
        raise ValueError(f"in-kernel transfers need even dims, got {tuple(shape)}")
    return rw, pw


def _fused_stages_cuda(
    values, offsets, b, x, stages, emit_residual, corner, restrict_transfer,
    ec, prolong_transfer, emit_x, halos=None, batch=False,
):
    """One launch of ``csrc/fused_stages.cu``: a visit of depth at most
    ``MAX_DEPTH`` on a 3D grid, or with ``batch`` on a ``(K, nz, ny, nx)``
    stack of them (with ``halos``, each member's slabs stacked alike)."""
    global LAUNCHES, LAUNCHES_HALO, LAUNCHES_BATCH, LAUNCHES_HALO_BATCH
    dev = b.device
    if b.ndim != 3 + int(batch):
        raise ValueError(f"b must be {3 + int(batch)}D, got shape {tuple(b.shape)}")
    shape = tuple(b.shape)
    lead = shape[:1] if batch else ()
    nz, ny, nx = shape[-3:]
    K = len(offsets)
    _check("b", b, None, dev)
    _check("values", values, (K,), dev)
    if K > 27 or any(abs(o) > 1 for off in offsets for o in off):
        raise ValueError("the kernel takes radius-1 stencils of at most 27 taps")
    if x is not None:
        _check("x", x, shape, dev)
    table = None
    if corner:
        table = corner[1]
        _check("region table", table, (len(corner[0]), K), dev)
    rw, pw = _transfer_weights(shape[-3:], dev, restrict_transfer, ec,
                               prolong_transfer, lead)
    n = len(stages)
    depth = n + int(bool(emit_residual)) + int(restrict_transfer is not None)
    if depth > MAX_DEPTH:
        raise ValueError(f"one launch takes a visit of depth <= {MAX_DEPTH}, got {depth}")

    writes_x = n > 0 or ec is not None
    if writes_x:
        # the stages, or the stage-free x + P·ec, write the iterate
        x_out = torch.empty_like(b)
    elif emit_x:
        # a residual of the iterate as it came
        x_out = torch.zeros_like(b) if x is None else x.clone()
    else:
        x_out = None
    mode, r_out = 0, None
    if emit_residual:
        if restrict_transfer is not None:
            cshape = lead + tuple(s // 2 for s in shape[-3:])
            mode, r_out = 2, torch.empty(cshape, dtype=b.dtype, device=dev)
        else:
            mode, r_out = 1, torch.empty_like(b)

    slabs, flags = [None] * 6, [0] * 6
    if halos is not None:
        (open_lo, open_hi), b_pair, x_pair, ec_pair = halos
        if b_pair is None:
            raise ValueError("halos without the slabs of b")
        flags[:2] = int(bool(open_lo)), int(bool(open_hi))
        # a slab's planes: axis 0, or axis 1 of a batch's (K, D, ...) slabs
        za = len(lead)
        trail = shape[za + 1:]
        for j, (name, pair) in enumerate((("b", b_pair), ("x", x_pair), ("ec", ec_pair))):
            if pair is None:
                continue
            for side, t in enumerate(pair):
                _check(f"{name} halo", t, None, dev)
                want = trail if name != "ec" else tuple(s // 2 for s in trail)
                if t.ndim != za + 3 or tuple(t.shape[:za]) != lead or \
                        tuple(t.shape[za + 1:]) != want:
                    raise ValueError(f"{name} halo of shape {tuple(t.shape)}")
                slabs[2 * j + side] = t.data_ptr()
        flags[2], flags[3] = b_pair[0].shape[za], b_pair[1].shape[za]
        if x is not None and (x_pair is None or tuple(
                t.shape[za] for t in x_pair) != tuple(flags[2:4])):
            raise ValueError("x needs halo slabs as deep as b's")
        if ec is not None:
            if ec_pair is None:
                raise ValueError("ec needs its halo slabs")
            flags[4], flags[5] = ec_pair[0].shape[za], ec_pair[1].shape[za]
        need = n + int(bool(emit_residual)) + int(restrict_transfer is not None)
        if min(flags[2:4]) < need or (ec is not None and (
                flags[4] < (need + 1) // 2 or flags[5] < need // 2 + 1)):
            raise ValueError(
                f"halo slabs of {flags[2:6]} planes for a visit of depth {need}"
            )
    offs_c = (ctypes.c_int * (3 * K))(*[o for off in offsets for o in off])
    rowmap_c = (ctypes.c_int * 8)(*_row_map(corner))
    kinds_c = (ctypes.c_int * max(n, 1))(*[_KIND_CODE[k] for k, _ in stages])
    pars_c = (ctypes.c_float * max(n, 1))(*[float(p) for _, p in stages])
    rw_c = (ctypes.c_float * 3)(*rw)
    pw_c = (ctypes.c_float * 3)(*pw)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            ptr(values), ptr(table), offs_c, K, rowmap_c,
            ptr(b), ptr(x), ptr(ec),
            ptr(x_out) if writes_x else None, ptr(r_out),
            nz, ny, nx, n, kinds_c, pars_c, mode, rw_c, pw_c, *slabs, *flags,
            shape[0] if batch else 1, stream,
        )
    if rc != 0:
        raise RuntimeError(f"omg_fused_stages failed with code {rc}")
    if batch and halos is not None:
        LAUNCHES_HALO_BATCH += 1
    elif batch:
        LAUNCHES_BATCH += 1
    elif halos is None:
        LAUNCHES += 1
    else:
        LAUNCHES_HALO += 1
    if not emit_residual:
        return x_out
    if not emit_x:
        return r_out
    return x_out, r_out


def fused_stages_const_3d(
    values, offsets, b, x, stages, emit_residual: bool = False,
    corner=None, restrict_transfer=None, ec=None, prolong_transfer=None,
    emit_x: bool = True, halos=None,
):
    """Run ``stages`` half-sweeps (and optionally the final residual) for a
    constant or cornered 3D stencil.  ``x=None`` means a zero initial guess
    (the tensor is never read).  Returns ``x_out``, ``(x_out, r)``, or
    ``r`` alone with ``emit_x=False``.

    ``values``: ``(K,)`` interior taps (a tensor on ``b``'s device);
    ``offsets``: the K static offsets.  ``corner``: optional ``(regions,
    (n_regions, K) tap table)`` of a
    :class:`~openmg_tpu_torch.ops.stencil.CorneredOperator`.
    ``restrict_transfer`` (with ``emit_residual``): return the restricted
    coarse rhs ``bc = R r`` (shape halved per dim) in place of the fine
    residual.  ``ec`` + ``prolong_transfer``: start from ``x + P ec``.  Both
    need even grid dims.

    A visit deeper than ``MAX_DEPTH`` is split into consecutive calls
    (:func:`depth_chunks`) on either device; every visit of a V(2,2) cycle
    is one launch.  Inputs are never modified.  On a CUDA tensor the kernel
    is enqueued on the current stream and the call does not wait for it.

    ``halos`` (a rank's z-slab): ``((open_lo, open_hi), (b_lo, b_hi),
    x_pair or None, ec_pair or None)``; ``b_lo`` holds the last D planes of
    the rank below, ``b_hi`` the first D of the rank above (zeros at a
    domain edge), D at least the visit's depth (:func:`halo_depth`); the
    coarse ``ec`` pair has ``D // 2`` and ``D // 2 + 1`` planes.
    ``corner`` is gated for the slab here (:func:`gate_corner`).  A halo
    visit must fit one launch (depth at most ``MAX_DEPTH``): the caller
    exchanges the iterate between chunks.
    """
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    stages = _norm_stages(stages)
    if halos is not None:
        corner = gate_corner(corner, halos[0][0])
        depth = len(stages) + int(bool(emit_residual)) + int(restrict_transfer is not None)
        if depth > MAX_DEPTH:
            raise ValueError(
                f"a halo visit of depth {depth}: one launch takes {MAX_DEPTH}"
            )
        if b.device.type == "cpu":
            return fused_stages_const_3d_plain(
                values, offsets, b, x, stages, emit_residual, corner,
                restrict_transfer, ec, prolong_transfer, emit_x, halos,
            )
        if b.device.type != "cuda":
            raise ValueError(f"unsupported device {b.device}")
        return _fused_stages_cuda(
            values, offsets, b, x, stages, emit_residual, corner,
            restrict_transfer, ec, prolong_transfer, emit_x, halos,
        )
    _visit_ok(stages, emit_residual, restrict_transfer, ec, emit_x)
    if b.device.type == "cpu":
        one = fused_stages_const_3d_plain
    elif b.device.type == "cuda":
        one = _fused_stages_cuda
    else:
        raise ValueError(f"unsupported device {b.device}")
    return _chunked(one, values, offsets, b, x, stages, emit_residual, corner,
                    restrict_transfer, ec, prolong_transfer, emit_x)


def _visit_ok(stages, emit_residual, restrict_transfer, ec, emit_x):
    if not emit_x and not (emit_residual and not stages):
        raise ValueError(
            "emit_x=False only applies to stage-free residual(+restrict) calls"
        )
    if restrict_transfer is not None and not emit_residual:
        raise ValueError("restrict_transfer needs emit_residual")
    if not stages and not emit_residual and ec is None:
        raise ValueError("nothing to do: no stages, no ec, no residual")


def _chunked(one, values, offsets, b, x, stages, emit_residual, corner,
             restrict_transfer, ec, prolong_transfer, emit_x):
    """A visit through ``one`` (a launch or a plain call) in the chunks of
    :func:`depth_chunks`."""
    extra = int(bool(emit_residual)) + int(restrict_transfer is not None)
    chunks = depth_chunks(stages, extra, MAX_DEPTH)
    for i, chunk in enumerate(chunks):
        last = i == len(chunks) - 1
        out = one(
            values, offsets, b, x, chunk, emit_residual and last, corner,
            restrict_transfer if last else None, ec if i == 0 else None,
            prolong_transfer, emit_x,
        )
        x = out
    return out


def _batch_operands(offsets, tensors, what):
    """The grid dimension of a batch (from the operator's offsets, never
    from the tensors alone) after checking that every tensor is a
    ``(K, *grid)`` stack of one shape."""
    nd = len(offsets[0])
    shape = tuple(tensors[0].shape)
    if len(shape) != nd + 1 or shape[0] < 1:
        raise ValueError(
            f"{what}: a batch of {nd}D grids is (K, *grid), got shape {shape}"
        )
    for t in tensors:
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            got = tuple(t.shape) if isinstance(t, torch.Tensor) else type(t)
            raise ValueError(f"{what}: operand of shape {got}, expected {shape}")
    return nd


def _member_halos(halos, m):
    """Member ``m``'s ``halos`` of a batch's: its slabs, the flags shared."""
    flags, *pairs = halos
    return (flags,) + tuple(None if p is None else (p[0][m], p[1][m]) for p in pairs)


def _halo_batch_ok(halos, K, depth):
    """Raise unless ``halos`` are a batch's: K members' slabs each, and a
    visit one launch takes."""
    for p in halos[1:]:
        if p is not None and any(t.ndim != 4 or t.shape[0] != K for t in p):
            raise ValueError(
                f"K1hb: halo slabs of shapes {[tuple(t.shape) for t in p]} for "
                f"{K} members; each (K, planes, ny, nx)"
            )
    if depth > MAX_DEPTH:
        raise ValueError(f"a halo visit of depth {depth}: one launch takes {MAX_DEPTH}")


def fused_stages_const_3d_batch_plain(
    values, offsets, b, x, stages, emit_residual: bool = False,
    corner=None, restrict_transfer=None, ec=None, prolong_transfer=None,
    emit_x: bool = True, halos=None,
):
    """Plain version of :func:`fused_stages_const_3d_batch`: the scalar
    plain version on each member (in the same chunks; with ``halos``, the
    scalar halo form on each member's slabs, ``corner`` gated), stacked."""
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    stages = _norm_stages(stages)
    if _batch_operands(offsets, (b,) if x is None else (b, x), "K1b") != 3:
        raise ValueError("K1b takes a batch of 3D grids")
    _visit_ok(stages, emit_residual, restrict_transfer, ec, emit_x)
    if halos is not None:
        _halo_batch_ok(halos, b.shape[0], len(stages) + int(bool(emit_residual))
                       + int(restrict_transfer is not None))
        outs = [
            fused_stages_const_3d_plain(
                values, offsets, b[m], None if x is None else x[m], stages,
                emit_residual, corner, restrict_transfer,
                None if ec is None else ec[m], prolong_transfer, emit_x,
                _member_halos(halos, m))
            for m in range(b.shape[0])
        ]
    else:
        outs = [
            _chunked(fused_stages_const_3d_plain, values, offsets, b[m],
                     None if x is None else x[m], stages, emit_residual, corner,
                     restrict_transfer, None if ec is None else ec[m],
                     prolong_transfer, emit_x)
            for m in range(b.shape[0])
        ]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[j] for o in outs]) for j in range(len(outs[0])))
    return torch.stack(outs)


def fused_stages_const_3d_batch(
    values, offsets, b, x, stages, emit_residual: bool = False,
    corner=None, restrict_transfer=None, ec=None, prolong_transfer=None,
    emit_x: bool = True, halos=None,
):
    """K1b: :func:`fused_stages_const_3d` on K members of one level at
    once: ``b`` and ``x`` ``(K, nz, ny, nx)``, ``ec`` ``(K, nz/2, ny/2,
    nx/2)``, the outputs stacked likewise; one operator, stage list and
    transfer for all.  On a CUDA tensor one launch a chunk for the whole
    batch (every visit of a V(2,2) cycle is one), each member bit-equal to
    the scalar launch on it; on a CPU tensor the plain version.

    ``halos`` (K1hb: K members of a rank's slab): as the scalar halo form's
    (:func:`fused_stages_const_3d`), each slab a stack of the members'
    ``(K, D, ny, nx)`` (``ec``'s ``(K, D/2 (+1), ny/2, nx/2)``), the flags
    shared, ``corner`` gated here; one launch, each member bit-equal to the
    scalar halo launch on its slabs."""
    if halos is not None:
        corner = gate_corner(corner, halos[0][0])
    if b.device.type == "cpu":
        return fused_stages_const_3d_batch_plain(
            values, offsets, b, x, stages, emit_residual, corner,
            restrict_transfer, ec, prolong_transfer, emit_x, halos,
        )
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    offsets = tuple(tuple(int(o) for o in off) for off in offsets)
    stages = _norm_stages(stages)
    if _batch_operands(offsets, (b,) if x is None else (b, x), "K1b") != 3:
        raise ValueError("K1b takes a batch of 3D grids")
    _visit_ok(stages, emit_residual, restrict_transfer, ec, emit_x)
    if halos is not None:
        _halo_batch_ok(halos, b.shape[0], len(stages) + int(bool(emit_residual))
                       + int(restrict_transfer is not None))
        return _fused_stages_cuda(
            values, offsets, b, x, stages, emit_residual, corner,
            restrict_transfer, ec, prolong_transfer, emit_x, halos, batch=True,
        )

    def one(*a):
        return _fused_stages_cuda(*a, batch=True)

    return _chunked(one, values, offsets, b, x, stages, emit_residual, corner,
                    restrict_transfer, ec, prolong_transfer, emit_x)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _batched(op, b) -> bool:
    """Whether ``b`` is a batch ``(K, *grid)`` of ``op``'s grids, decided by
    the operator's dimension and never by the tensor's alone: a batch of 2D
    planes has the shape of a 3D grid."""
    return b.ndim == op.ndim + 1


def _stencil_ok(op, b) -> bool:
    """Whether K1 (or K1b, for a batch) takes ``op`` on ``b``."""
    return (
        (op.is_constant or isinstance(op, CorneredOperator))
        and b.dtype == torch.float32
        and op.ndim == 3
        and b.ndim in (3, 4)
        and len(op.offsets) <= 27
        and all(abs(o) <= 1 for off in op.offsets for o in off)
    )


def _visit_3d(op, b, halos=None, **kw):
    """The 3D visit function for ``b``: K1b's for a batch, else K1's (with
    ``halos``, a rank's slab: K1hb, K1h)."""
    if _batched(op, b):
        return lambda *a: fused_stages_const_3d_batch(*a, halos=halos, **kw)
    return lambda *a: fused_stages_const_3d(*a, halos=halos, **kw)


def _corner_info(op):
    """``(regions, (n_regions, K) tap table)`` of a cornered operator, else
    None."""
    if isinstance(op, CorneredOperator):
        return op.regions, op.table
    return None


def _transfer_ok(shape, transfer) -> bool:
    return (
        transfer is not None
        and _axis_weights(transfer.r_taps) is not None
        and _axis_weights(transfer.p_taps) is not None
        and all(s % 2 == 0 for s in shape)
    )


def _fused2d(name, op, b, x, iterations: int, omega: float,
             emit_residual: bool, restrict_transfer=None, ec=None,
             prolong_transfer=None):
    """A 2D level visit in one call of
    :func:`~openmg_tpu_torch.ops.kernels.fused_stages_2d` (K5): all stages,
    the optional residual, restriction and prolongation.  Returns None when
    there are no stages or the kernel does not take the case: not float32,
    not a constant or cornered radius-1 2D operator, an odd dimension with a
    transfer.  Planes of any size are taken (the kernel tiles them).  A
    batch ``(K, ny, nx)`` goes to K5b in one call."""
    from openmg_tpu_torch.ops import kernels

    stages = stages_for(name, iterations, omega)
    if stages is None or not stages:
        return None
    batch = _batched(op, b)
    if op.ndim != 2 or b.ndim != 2 + batch or b.dtype != torch.float32:
        return None
    if not (op.is_constant or isinstance(op, CorneredOperator)):
        return None
    if any(abs(o) > 1 for off in op.offsets for o in off):
        return None
    for tr in (restrict_transfer, prolong_transfer):
        if tr is not None and not _transfer_ok(b.shape[batch:], tr):
            return None
    visit = kernels.fused_stages_2d_batch if batch else kernels.fused_stages_2d
    return visit(
        op.values, op.offsets, b, x, stages, corner=_corner_info(op),
        emit_residual=emit_residual, restrict_transfer=restrict_transfer,
        ec=ec, prolong_transfer=prolong_transfer,
    )


def smooth_fused(name, op, b, x, iterations: int, omega: float):
    """All stages of ``iterations`` sweeps on an existing iterate.  Returns
    the smoothed ``x`` or None when the kernel does not take the case.

    Every entry point takes a batch ``(K, *grid)`` of ``op``'s grids too
    (``x``, ``ec`` and the outputs stacked likewise): one call of K1b or
    K5b for the whole batch."""
    if op.ndim == 2:
        return _fused2d(name, op, b, x, iterations, omega, False)
    stages = stages_for(name, iterations, omega)
    if stages is None or not stages or not _stencil_ok(op, b):
        return None
    return _visit_3d(op, b, corner=_corner_info(op))(
        op.values, op.offsets, b, x, stages
    )


def presmooth_residual_fused(name, op, b, iterations: int, omega: float):
    """Zero-initial-guess pre-smoothing with the level residual: returns
    ``(x, r)`` reading only ``b``, or None when unsupported."""
    if op.ndim == 2:
        return _fused2d(name, op, b, None, iterations, omega, True)
    stages = stages_for(name, iterations, omega)
    if stages is None or not stages or not _stencil_ok(op, b):
        return None
    return _visit_3d(op, b, emit_residual=True, corner=_corner_info(op))(
        op.values, op.offsets, b, None, stages
    )


def presmooth_restrict_fused(name, op, b, x, iterations: int, omega: float,
                             transfer, halos=None):
    """Pre-smoothing with the level residual AND its restriction: returns
    ``(x, bc)`` where ``bc = R (b − A x)`` is the next level's rhs, or None
    when unsupported.  ``x=None`` is the zero-start path (reads only
    ``b``).  The fine residual is never stored.  ``halos``: a rank's slab
    (:func:`fused_stages_const_3d`)."""
    if op.ndim == 2 and halos is None:
        return _fused2d(name, op, b, x, iterations, omega, True,
                        restrict_transfer=transfer)
    stages = stages_for(name, iterations, omega)
    if (
        stages is None
        or not stages
        or not _stencil_ok(op, b)
        or not _transfer_ok(b.shape[-3:], transfer)
    ):
        return None
    return _visit_3d(
        op, b, halos, emit_residual=True, corner=_corner_info(op),
        restrict_transfer=transfer,
    )(op.values, op.offsets, b, x, stages)


def residual_restrict_fused(op, b, x, transfer, halos=None):
    """The level residual with its restriction, no smoothing stages:
    ``bc = R (b − A x)`` without storing the fine residual or rewriting
    ``x``.  Returns ``bc`` or None when unsupported (every 2D grid, as in
    the JAX package).  ``halos``: a rank's slab."""
    if not _stencil_ok(op, b) or not _transfer_ok(b.shape[-3:], transfer):
        return None
    return _visit_3d(
        op, b, halos, emit_residual=True, corner=_corner_info(op),
        restrict_transfer=transfer, emit_x=False,
    )(op.values, op.offsets, b, x, ())


def prolong_smooth_fused(name, op, b, x, ec, iterations: int, omega: float,
                         transfer, halos=None):
    """Coarse-correction prolongation + add with post-smoothing: returns
    ``smooth(b, x + P ec)`` without storing ``P ec``, or None when
    unsupported.  ``iterations=0`` is the prolongation and add alone (3D
    only: a 2D visit with no stages returns None, as in the JAX package).
    ``halos``: a rank's slab."""
    if op.ndim == 2 and halos is None:
        return _fused2d(name, op, b, x, iterations, omega, False,
                        ec=ec, prolong_transfer=transfer)
    stages = stages_for(name, iterations, omega)
    if (
        stages is None
        or not _stencil_ok(op, b)
        or not _transfer_ok(b.shape[-3:], transfer)
    ):
        return None
    return _visit_3d(
        op, b, halos, corner=_corner_info(op), ec=ec, prolong_transfer=transfer,
    )(op.values, op.offsets, b, x, stages)
