"""Halo exchange and halo-aware grid ops on row-partitioned slabs (twin of
``openmg_tpu/parallel/halo.py``).

Each rank owns a contiguous slab of grid axis 0.  The stencils and the
``linear`` transfer reach one plane across a slab boundary, so a pass needs
one received plane each way (:func:`halo_planes`); a fused level visit of
depth D needs D planes each way (:func:`halo_slabs`).  The grid boundary is
Dirichlet-truncated: the first rank's lower halo and the last rank's upper
halo are zeros (there is no ring to wrap, so nothing is sent there).

**Transport.**  Planes move with ``torch.distributed.batch_isend_irecv``
(the JAX package's ``lax.ppermute``), sums with ``all_reduce`` (``psum``),
the partitioned-to-replicated transition with ``all_gather_into_tensor``
(``all_gather``).  NCCL moves CUDA tensors card to card.  gloo moves CPU
tensors only, so on a gloo group with CUDA tensors (several ranks sharing
one card) :class:`Comm` copies every plane through pinned host buffers, on
purpose and by the group's backend: ``transport`` names the path and
``stats`` counts the exchanges, the bytes they send and stage through the
host, the copies, the reductions and the gathers (apart: the coarse
transition and the delivery of the whole solution).  Nothing
here tries one transport and falls back to another.

The tensor-code helpers (:func:`halo_exchange`, :func:`shifted_ext`,
:func:`restrict_axis0_ext`, :func:`prolong_axis0_ext`) serve the
partitioned transfers and the double-float outer residual; every stencil
pass and visit of a partitioned level hands the received planes to the
halo forms of the stencil kernels (:mod:`openmg_tpu_torch.parallel.fast`).
The JAX package's tensor-code apply over halos (``apply_ext``,
``apply_overlapped``, its ``overlap_halo=False`` path) has no twin here.

**A stack of members** (``solve_many``: the JAX package's ``vmap`` over its
``shard_map`` loop, whose ``ppermute`` then carries every member's planes):
every function here takes ``axis=1`` for a ``(K, local, ...)`` stack, whose
partition axis is axis 1.  An exchange then sends one contiguous ``(K, lo,
...)`` message an item for the whole stack (``planes_sent`` counts K·lo
planes), a gather interleaves the ranks' slabs along axis 1, and the
members' sums (:meth:`Comm.all_reduce`, :meth:`Comm.host_sums` with
``members=True``) are each member's scalar reduction: gloo's ring adds the
entries of a vector over more than two ranks in an order that depends on
their place in it, so there a member's sum is a reduction of its own (two
ranks' sum is the same in any order: one reduction).  The pinned buffers of
the staged path are kept per shape, so a batch that narrows as its members
converge adds one set a batch size.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.distributed as dist

from openmg_tpu_torch.ops.stencil import shift

__all__ = [
    "Comm",
    "halo_exchange",
    "halo_planes",
    "halo_slabs",
    "open_flags",
    "shifted_ext",
    "restrict_axis0_ext",
    "prolong_axis0_ext",
]


class Comm:
    """The partition axis as the partitioned ops use it: the group, this
    rank's ``index`` among ``size`` ranks, the device, the transport, and
    counters (``stats``).  ``mesh`` is a
    :class:`~openmg_tpu_torch.parallel.mesh.Mesh`; with ``size == 1`` no
    collective is ever called (``force_partition``: every halo is zero)."""

    def __init__(self, mesh, device):
        self.group = mesh.group
        self.ranks = tuple(mesh.ranks)
        self.index = mesh.index
        self.size = len(self.ranks)
        self.device = torch.device(device)
        self.backend = dist.get_backend(self.group) if dist.is_initialized() else "none"
        # gloo takes CPU tensors only: stage CUDA tensors through the host
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        if self.size == 1:
            self.transport = "none (one rank)"
        elif self.staged:
            self.transport = "gloo, staged through pinned host buffers"
        else:
            self.transport = f"{self.backend}, {self.device.type} tensors"
        self._pinned = {}
        self.stats = {}
        self.reset_stats()

    def reset_stats(self):
        self.stats.update(
            exchanges=0, planes_sent=0, bytes_sent=0, staged_copies=0,
            staged_bytes=0, reductions=0, gathers=0, gathered_bytes=0,
        )

    # -- staging ---------------------------------------------------------

    def _host(self, shape, dtype, key):
        """A pinned host buffer of this shape, kept for reuse."""
        k = (tuple(shape), dtype, key)
        buf = self._pinned.get(k)
        if buf is None:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._pinned[k] = buf
        return buf

    def _to_host(self, t, key, count=True):
        h = self._host(t.shape, t.dtype, key)
        h.copy_(t)
        self.stats["staged_copies"] += 1
        if count:
            self.stats["staged_bytes"] += t.numel() * t.element_size()
        return h

    def _from_host(self, h, out, count=True):
        # a blocking copy: the next exchange reuses the pinned buffer
        out.copy_(h)
        self.stats["staged_copies"] += 1
        if count:
            self.stats["staged_bytes"] += h.numel() * h.element_size()
        return out

    # -- point to point --------------------------------------------------

    def exchange(self, items, axis=0):
        """One batch of halo sends: ``items`` is a list of ``(x, lo, hi)``
        (a slab and the planes wanted below and above it); returns, per
        item, ``(lower, upper)``: the ``lo`` last planes of the rank below
        and the ``hi`` first planes of the rank above, zeros at the domain
        edges.  ``axis``: the slabs' partition axis (1 for a stack of
        members, whose planes then move in one message an item)."""
        out = []
        for x, lo, hi in items:
            if max(lo, hi) > x.shape[axis]:
                raise ValueError(
                    f"a halo of {max(lo, hi)} planes from a slab of {x.shape[axis]}"
                )
            out.append([
                torch.zeros(_with(x.shape, axis, w), dtype=x.dtype, device=x.device)
                for w in (lo, hi)
            ])
        if self.size == 1:
            return [tuple(p) for p in out]
        i, n = self.index, self.size
        ops, landing = [], []
        for j, (x, lo, hi) in enumerate(items):
            sends = []
            if i + 1 < n and lo:
                sends.append((x.narrow(axis, x.shape[axis] - lo, lo), self.ranks[i + 1],
                              ("up", j)))
            if i > 0 and hi:
                sends.append((x.narrow(axis, 0, hi), self.ranks[i - 1], ("down", j)))
            for t, peer, key in sends:
                t = t.contiguous()
                if self.staged:
                    t = self._to_host(t, ("send",) + key)
                ops.append(dist.P2POp(dist.isend, t, peer, group=self.group))
                self.stats["planes_sent"] += math.prod(t.shape[:axis + 1])
                self.stats["bytes_sent"] += t.numel() * t.element_size()
            recvs = []
            if i > 0 and lo:
                recvs.append((0, self.ranks[i - 1], ("lo", j)))
            if i + 1 < n and hi:
                recvs.append((1, self.ranks[i + 1], ("hi", j)))
            for side, peer, key in recvs:
                dst = out[j][side]
                buf = self._host(dst.shape, dst.dtype, ("recv",) + key) if self.staged else dst
                ops.append(dist.P2POp(dist.irecv, buf, peer, group=self.group))
                landing.append((buf, dst))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if self.staged:
            for buf, dst in landing:
                self._from_host(buf, dst)
        self.stats["exchanges"] += 1
        return [tuple(p) for p in out]

    # -- collectives -----------------------------------------------------

    def _reduce(self, t, members):
        """Sum ``t`` over the ranks in place: one reduction, or with
        ``members`` (a ``(K,)`` vector of the members' values) each
        member's by the reduction its scalar solve makes (module note)."""
        if members and self.size > 2 and t.numel() > 1:
            for k in range(t.numel()):
                dist.all_reduce(t[k:k + 1], group=self.group)
            self.stats["reductions"] += t.numel()
        else:
            dist.all_reduce(t, group=self.group)
            self.stats["reductions"] += 1

    def all_reduce(self, t, members=False):
        """The sum of ``t`` over the ranks (a new tensor on ``t``'s
        device); ``members``: ``t`` is a ``(K,)`` vector of the members'
        values of a stack, each summed as its scalar solve sums it."""
        if self.size == 1:
            return t
        if self.staged:
            h = t.detach().cpu()
            self.stats["staged_copies"] += 2
            self.stats["staged_bytes"] += 2 * h.numel() * h.element_size()
            self._reduce(h, members)
            return h.to(t.device)
        t = t.clone()
        self._reduce(t, members)
        return t

    def all_max(self, t):
        """The largest ``t`` over the ranks."""
        if self.size == 1:
            return t
        self.stats["reductions"] += 1
        h = t.detach().cpu() if self.staged else t.clone()
        dist.all_reduce(h, op=dist.ReduceOp.MAX, group=self.group)
        return h.to(t.device)

    def host_sums(self, t, members=False):
        """The sum of ``t`` over the ranks as a host tensor: one read of
        ``t`` to the host (the reduction runs on the host under gloo, on
        the device under NCCL); ``members`` as in :meth:`all_reduce`."""
        if self.size > 1 and not self.staged:
            return self.all_reduce(t, members).cpu()
        h = t.detach().cpu()
        if self.size > 1:
            self._reduce(h, members)
        return h

    def all_gather(self, t, axis=0):
        """The slabs of every rank joined along ``axis`` (1 for a stack of
        members: each member's whole grid), in rank order."""
        if self.size == 1:
            return t
        if axis:
            whole = self.all_gather(t)
            parts = whole.reshape((self.size,) + tuple(t.shape))
            return parts.movedim(0, axis).reshape(
                _with(t.shape, axis, self.size * t.shape[axis]))
        self.stats["gathers"] += 1
        t = t.contiguous()
        self.stats["gathered_bytes"] += t.numel() * t.element_size() * self.size
        src = self._to_host(t, ("gather",), count=False) if self.staged else t
        out = torch.empty((src.shape[0] * self.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        with warnings.catch_warnings():
            # newer releases rename it all_gather_single; the card's does not
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, src, group=self.group)
        if self.staged:
            return self._from_host(
                out, torch.empty(out.shape, dtype=out.dtype, device=t.device),
                count=False,
            )
        return out


def _with(shape, axis, n):
    """``shape`` with ``n`` at ``axis``."""
    return tuple(shape[:axis]) + (int(n),) + tuple(shape[axis + 1:])


def halo_slabs(x, comm: Comm, lo_width: int, hi_width: int | None = None, axis=0):
    """``(lower, upper)``: the ``lo_width`` last planes of the rank below
    and the ``hi_width`` first planes of the rank above (zeros at the domain
    edges).  The fused visits take D-deep slabs; the passes one plane
    (:func:`halo_planes`).  ``axis``: 1 for a stack of members."""
    if hi_width is None:
        hi_width = lo_width
    return comm.exchange([(x, lo_width, hi_width)], axis)[0]


def halo_planes(x, comm: Comm, axis=0):
    """The two received planes ``(lower, upper)``, each ``(1, *trailing)``
    (``(K, 1, *trailing)`` for a stack, ``axis=1``; zeros at the domain
    edges)."""
    return halo_slabs(x, comm, 1, 1, axis)


def halo_exchange(x, comm: Comm, axis=0):
    """``x`` with one received plane on each side: ``(local + 2, ...)``
    (along ``axis``)."""
    lower, upper = halo_planes(x, comm, axis)
    return torch.cat([lower, x, upper], dim=axis)


def open_flags(comm: Comm):
    """``(open_lo, open_hi)``: does this rank's slab have a neighbour below
    and above?  The halo forms widen the valid range of z at an open edge
    and keep the Dirichlet zero at a true domain edge; a cornered level's
    axis-0 regions lie on the first rank only (``open_lo`` 0)."""
    return int(comm.index > 0), int(comm.index < comm.size - 1)


def shifted_ext(x_ext, off, axis=0):
    """``z[i] = x[i + off]`` on the local slab, from the one-plane halo for
    ``off[0]`` in {−1, 0, 1} and zero-filled shifts on the trailing axes
    (the partition axis ``axis``: 1 for a stack)."""
    o0 = off[0]
    if not -1 <= o0 <= 1:
        raise ValueError(f"axis-0 offset {o0} exceeds halo width 1")
    local = x_ext.shape[axis] - 2
    sl = x_ext.narrow(axis, 1 + o0, local)
    rest = (0,) + tuple(off[1:])
    if all(o == 0 for o in rest):
        return sl
    return shift(sl, rest)


def restrict_axis0_ext(v_ext, taps, axis=0):
    """Axis-0 restriction of a halo-extended slab: ``out[I] = Σ_t w(t) ·
    v[2I + t]``, the halo supplying the taps across the boundary (the
    local extent is even; ``axis``: 1 for a stack)."""
    local = v_ext.shape[axis] - 2
    m = local // 2
    lead = (slice(None),) * axis
    out = None
    for t, w in taps:
        start = 1 + t
        term = v_ext[lead + (slice(start, start + 2 * (m - 1) + 1, 2),)] * w
        out = term if out is None else out + term
    return out


def prolong_axis0_ext(u_ext, taps, axis=0):
    """Axis-0 prolongation of a halo-extended coarse slab:
    ``out[2I + pm] = Σ_{t ≡ pm (2)} w(t) · u[I − (t − pm)/2]`` (``axis``:
    1 for a stack)."""
    local = u_ext.shape[axis] - 2
    parts = []
    for pm in (0, 1):
        part = None
        for t, w in taps:
            if t % 2 != pm:
                continue
            s = (t - pm) // 2
            term = u_ext.narrow(axis, 1 - s, local) * w
            part = term if part is None else part + term
        parts.append(part)
    stacked = torch.stack(parts, dim=axis + 1)
    return stacked.reshape(_with(u_ext.shape, axis, local * 2))
