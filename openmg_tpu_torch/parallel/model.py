"""Static communication and memory-traffic model of the distributed solvers
(twin of ``openmg_tpu/parallel/model.py``).

What a rank of :class:`~openmg_tpu_torch.parallel.dist.DistributedSolver`
or :class:`~openmg_tpu_torch.parallel.sparse_dist.DistributedAlgebraicSolver`
sends in an outer step is a static function of the partition plan, the
level shapes and the solver's per-level dispatch.  The solvers own that
dispatch and state it: the stencil engine's ``visits`` (which steps of a
level visit K1h takes, at which halo depth, and its smoothing chunks), the
sparse engine's ``levels[i].tier`` and ``.sweeps`` (what an ``Ax`` and a
smoothing iteration exchange).  The two functions here walk an outer step
(the inner solve, whatever its cycle or Krylov method, and the outer update
with its residual), read each level's step from those plans, and count what
:class:`~openmg_tpu_torch.parallel.halo.Comm` counts in ``stats``:

* ``halo_bytes_per_cycle``: the bytes this rank sends point to point
  (``stats["bytes_sent"]``): a rank at a domain edge sends one side only;
* ``staged_bytes_per_cycle``: what a gloo group with CUDA tensors copies
  through the host (``stats["staged_bytes"]``: the planes sent and
  received, and each ``all_reduce`` operand both ways), 0 otherwise;
* ``gathered_bytes_per_cycle``: the ``all_gather`` outputs
  (``stats["gathered_bytes"]``), and ``delivery_gathered_bytes``, the
  gathers that deliver the whole solution once a solve;

all exact: a solve from a zero guess that takes ``c`` cycles counts ``c``
times the first and, for the gathers, ``delivery_gathered_bytes`` more.  A
world of one rank sends nothing (its halos are zeros).

What each step exchanges: a K1h visit its D-deep slabs of ``b`` and ``x``
(and the coarse correction's ``D // 2`` below and ``D // 2 + 1`` above) in
one batch, smoothing in chunks ``b`` once and ``x`` before each chunk,
every K3h or K4h pass (and the tensor transfers' axis-0 taps) one plane
each way, K2h's outer step one batch of ``(x_hi, x_lo, e)`` planes, the
partitioned → replicated transition one gather.  On the sparse engine
``H`` rows each way an ``Ax`` on a banded partitioned level, a gather an
``Ax`` on the gathered-x tier, a gather of a partitioned source a transfer,
and the outer residual's ``(x_hi, x_lo)`` pair.

``hbm_bytes_per_cycle`` estimates the device-memory traffic of an outer
step: each launch (and each tensor operation of the tensor-code paths)
reads its inputs once and writes its outputs once, halos and re-reads
inside a launch not counted; the coarsest level's dense solve reads its
inverse.  From the two, roofline-style bounds for a mesh of cards:

    t_comp  = hbm_bytes / hbm_bytes_per_s
    t_comm  = link_bytes / link_bytes_per_s   (halo bytes plus the
              (n − 1)/n share of the gathers a rank moves in a ring)
    efficiency_bound_overlap    = t_comp / max(t_comp, t_comm)
    efficiency_bound_no_overlap = t_comp / (t_comp + t_comm)

``hbm_bytes_per_s`` defaults to the H100 SXM data sheet's 3.35e12 B/s.
``link_bytes_per_s`` defaults to 4.5e11 B/s, the data sheet's NVLink rate
of one H100 SXM each way (900 GB/s both ways): a data-sheet figure, not a
measurement, since one card has no link to measure.  The output keeps the
JAX package's keys (``assumed_ici_bytes_per_s`` holds the link rate).
"""

from __future__ import annotations

import math

import torch

__all__ = ["comm_model", "comm_model_sparse"]

HBM_BYTES_PER_S = 3.35e12
LINK_BYTES_PER_S = 4.5e11


class _Tally:
    """What one rank (``index`` of ``n``) counts, per key (a level index or
    ``"outer"``), as :class:`~openmg_tpu_torch.parallel.halo.Comm` counts
    it."""

    def __init__(self, n, index, staged):
        self.n, self.index, self.staged = n, index, staged
        self.sent, self.stage, self.gathered, self.hbm = {}, {}, {}, {}
        self.flags = {}

    def _add(self, d, key, v):
        d[key] = d.get(key, 0) + v

    def exchange(self, key, items):
        """One ``Comm.exchange``: ``items`` of ``(planes below, planes
        above, bytes a plane)``."""
        if self.n == 1:
            return
        up, down = self.index + 1 < self.n, self.index > 0
        for lo, hi, pb in items:
            sent = ((lo if up else 0) + (hi if down else 0)) * pb
            got = ((lo if down else 0) + (hi if up else 0)) * pb
            self._add(self.sent, key, sent)
            if self.staged:
                self._add(self.stage, key, sent + got)

    def all_reduce(self, key, nbytes):
        if self.n > 1 and self.staged:
            self._add(self.stage, key, 2 * nbytes)

    def all_gather(self, key, share_bytes):
        if self.n > 1:
            self._add(self.gathered, key, share_bytes * self.n)

    def memory(self, key, nbytes):
        self._add(self.hbm, key, nbytes)


def _bounds(tally, levels, link_bytes_per_s, hbm_bytes_per_s, cycles,
            delivery, per_level):
    n = tally.n
    halo = sum(tally.sent.values())
    staged = sum(tally.stage.values())
    gathered = sum(tally.gathered.values())
    hbm = sum(tally.hbm.values())
    link = halo + gathered * (n - 1) / n
    t_comp = cycles * hbm / hbm_bytes_per_s
    t_comm = cycles * link / link_bytes_per_s
    return {
        "per_level": per_level,
        "halo_bytes_per_cycle": halo,
        "staged_bytes_per_cycle": staged,
        "gathered_bytes_per_cycle": gathered,
        "delivery_gathered_bytes": delivery,
        "outer_halo_bytes": tally.sent.get("outer", 0),
        "link_bytes_per_cycle": link,
        "hbm_bytes_per_cycle": hbm,
        "comm_fraction_no_overlap": (
            t_comm / (t_comp + t_comm) if t_comp + t_comm else 0.0
        ),
        "efficiency_bound_overlap": t_comp / max(t_comp, t_comm) if t_comp else 1.0,
        "efficiency_bound_no_overlap": (
            t_comp / (t_comp + t_comm) if t_comp + t_comm else 1.0
        ),
        "assumed_hbm_bytes_per_s": hbm_bytes_per_s,
        "assumed_ici_bytes_per_s": link_bytes_per_s,
        "rank": tally.index,
        "n_devices": n,
    }


def _level_rows(tally, levels, shape_of, plan):
    return [
        {"level": i, "shape": list(shape_of(i)), "partitioned": bool(plan[i]),
         "halo_bytes": tally.sent.get(i, 0), "staged_bytes": tally.stage.get(i, 0),
         "gathered_bytes": tally.gathered.get(i, 0), "hbm_bytes": tally.hbm.get(i, 0),
         **tally.flags.get(i, {})}
        for i in range(levels)
    ]


def comm_model(
    solver,
    link_bytes_per_s: float = LINK_BYTES_PER_S,
    hbm_bytes_per_s: float = HBM_BYTES_PER_S,
    cycles: int = 1,
):
    """The per-outer-step accounting of this rank of a
    :class:`~openmg_tpu_torch.parallel.dist.DistributedSolver`, and the
    efficiency bounds (module docstring).  ``per_level[i]``: the level's
    bytes and whether K1h took its visits (``deep_fused``: both;
    ``partial_pre``: the stage-free residual and restriction;
    ``partial_post``: the prolongation with one sweep)."""
    s, cfg = solver, solver.config
    L = s.hierarchy.num_levels
    n = s.n_dev
    t = _Tally(n, s.mesh.index, s.comm.staged)
    pre, post, sm = cfg.pre_iterations, cfg.post_iterations, cfg.smoother
    es = torch.empty((), dtype=s.dtype).element_size()
    gamma = {"v": 1, "w": 2, "f": 1}[cfg.cycle_type]

    def shape(i):
        return tuple(int(v) for v in s.stats[i][0])

    def count(i):
        return math.prod(s.slab_shape(i))

    def pb(i):  # bytes of one plane of the level's slab
        return es * math.prod(s.slab_shape(i)[1:])

    def taps(i):
        A = s.ops[i]
        return 0 if s.kinds[i] != "vary" else len(A.offsets)

    def flag(i, k):
        t.flags.setdefault(i, {})[k] = True

    def smooth(i, iters):
        """K1h chunks where the plan has them, else a pass a launch (K3h /
        K4h), one plane each way."""
        if iters <= 0:
            return
        sizes = s.visits[i].chunks.get(iters)
        if sizes:
            t.exchange(i, [(sizes[0], sizes[0], pb(i))])
            for c in sizes:
                t.exchange(i, [(c, c, pb(i))])
                t.memory(i, 3 * es * count(i))
            return
        k = iters if sm == "chebyshev" else iters * (2 if sm == "rbgs" else 1)
        for _ in range(k):
            t.exchange(i, [(1, 1, pb(i))])
            t.memory(i, (3 + taps(i)) * es * count(i))

    def restrict(i):
        if s.plan[i] and 0 in s.coarsened_axes[i]:
            t.exchange(i, [(1, 1, pb(i))])
        coarse = count(i) // 2 ** len(s.coarsened_axes[i])
        t.memory(i, (3 * count(i) + coarse) * es)
        if s.plan[i] and not s.plan[i + 1]:
            t.all_gather(i, es * coarse)

    def prolong(i):
        if s.plan[i] and s.plan[i + 1] and 0 in s.coarsened_axes[i]:
            t.exchange(i, [(1, 1, pb(i))])
        t.memory(i, 4 * es * count(i) + es * count(i + 1))

    def post_visit(i, d):
        t.exchange(i, [(d, d, pb(i)), (d, d, pb(i)), (d // 2, d // 2 + 1, pb(i + 1))])
        t.memory(i, 3 * es * count(i) + es * count(i + 1))

    def replicated(i):
        """The single-device cycle from level i on every rank: memory only."""
        if i == L - 1:
            nc = count(i)
            t.memory(i, es * (nc * nc + 2 * nc))
            return
        if s.kinds[i] in ("const", "corner") and len(shape(i)) == 3:
            t.memory(i, es * (5 * count(i) + 2 * count(i + 1)))
        else:
            k = (pre + post) * (1 if sm == "jacobi" else 2) + 1
            t.memory(i, k * (3 + taps(i)) * es * count(i)
                     + 7 * es * count(i) + 2 * es * count(i + 1))
        for _ in range(1 if i == L - 2 else gamma):
            replicated(i + 1)

    def vc(i, x_zero):
        """``DistributedSolver._vc``: each step as ``visits[i]`` says."""
        if not s.plan[i]:
            replicated(i)
            return
        v = s.visits[i]
        if v.pre is not None:
            t.exchange(i, [(v.pre, v.pre, pb(i))] * (1 if x_zero else 2))
            t.memory(i, es * ((2 if x_zero else 3) * count(i) + count(i + 1)))
            flag(i, "fused_pre")
        else:
            smooth(i, pre)
            d = v.residual_restrict
            if d is not None:
                t.exchange(i, [(d, d, pb(i))] * 2)
                t.memory(i, es * (2 * count(i) + count(i + 1)))
                flag(i, "partial_pre")
            else:
                t.exchange(i, [(1, 1, pb(i))])  # the residual pass
                t.memory(i, (3 + taps(i)) * es * count(i))
                restrict(i)
        for k in range(1 if i == L - 2 else gamma):
            vc(i + 1, k == 0)
        if v.post is not None:
            post_visit(i, v.post)
            flag(i, "fused_post")
        elif v.post_one is not None:
            post_visit(i, v.post_one)
            flag(i, "partial_post")
            smooth(i, post - 1)
        else:
            prolong(i)
            smooth(i, post)

    def cycle():
        if cfg.cycle_type == "f":
            for i in range(L - 1):
                restrict(i)
            vc(L - 1, True)
            for i in range(L - 2, -1, -1):
                prolong(i)
                vc(i, False)
        else:
            vc(0, True)

    if cfg.krylov == "pcg":
        for _ in range(cfg.krylov_iters):
            cycle()
            if s.plan[0]:
                t.exchange("outer", [(1, 1, pb(0))])
            t.memory("outer", (3 + taps(0)) * es * count(0) + 8 * es * count(0))
        if s.plan[0]:
            for _ in range(2 * cfg.krylov_iters):
                t.all_reduce("outer", es)
    else:
        cycle()
    if s._fused_terms is not None:
        t.exchange("outer", [(1, 1, pb(0))] * 3)
        t.memory("outer", 8 * es * count(0))
    else:
        if s.plan[0]:
            t.exchange("outer", [(1, 1, pb(0))] * 2)
        K = len(s.hierarchy.fine_hi.offsets)
        t.memory("outer", (2 * K + 6) * es * count(0))
    delivery = 2 * es * count(0) * n if s.plan[0] and n > 1 else 0
    for i in range(L):
        fl = t.flags.get(i, {})
        t.flags[i] = {
            "deep_fused": bool(fl.get("fused_pre") and fl.get("fused_post")),
            "partial_fused": bool(fl.get("partial_pre") or fl.get("partial_post")),
            "partial_pre": bool(fl.get("partial_pre")),
            "partial_post": bool(fl.get("partial_post")),
        }
    return _bounds(t, L, link_bytes_per_s, hbm_bytes_per_s, cycles, delivery,
                   _level_rows(t, L, shape, s.plan))


def comm_model_sparse(
    solver,
    link_bytes_per_s: float = LINK_BYTES_PER_S,
    hbm_bytes_per_s: float = HBM_BYTES_PER_S,
    cycles: int = 1,
):
    """The per-outer-step accounting of this rank of a
    :class:`~openmg_tpu_torch.parallel.sparse_dist.DistributedAlgebraicSolver`,
    with the same bounds as :func:`comm_model`.  An ``Ax`` on a level of
    ``k`` slots and ``m`` rows is charged ``(k + 3) · 4 · m`` bytes of
    memory (the slot planes, ``x``, ``b`` and the result), a transfer two
    passes over its whole source, the outer residual ``(2k + 4) · 4`` bytes
    a row."""
    s, cfg = solver, solver.config
    L = s.hierarchy.num_levels
    n = s.n_dev
    t = _Tally(n, s.mesh.index, s.comm.staged)
    pre, post = cfg.pre_iterations, cfg.post_iterations
    es = torch.empty((), dtype=s.dtype).element_size()

    def rows(i):
        lo, hi = s.rows[i]
        return hi - lo

    def k_of(i):
        return max(int(s.stats[i][1]), 1)

    def Ax(i):
        lv = s.levels[i]
        if lv.tier == "gathered":
            t.all_gather(i, es * rows(i))
        elif lv.tier == "banded" and lv.halo:
            t.exchange(i, [(lv.halo, lv.halo, es)])
        t.memory(i, (k_of(i) + 3) * es * rows(i))

    def smooth(i, iters):
        if iters <= 0:
            return
        if cfg.smoother != "chebyshev":
            iters *= s.levels[i].sweeps
        for _ in range(iters):
            Ax(i)

    def restrict(i):
        if s.plan[i]:
            t.all_gather(i, es * rows(i))
        t.memory(i, 2 * es * int(s.stats[i][0]))

    def prolong(i):
        if s.plan[i + 1]:
            t.all_gather(i, es * rows(i + 1))
        t.memory(i, 2 * es * int(s.stats[i + 1][0]))

    def vc(i, gamma):
        if i == L - 1:
            nc = rows(i)
            t.memory(i, es * (nc * nc + 2 * nc))
            return
        smooth(i, pre)
        Ax(i)
        restrict(i)
        for _ in range(1 if i == L - 2 else gamma):
            vc(i + 1, gamma)
        prolong(i)
        smooth(i, post)

    def cycle():
        if cfg.cycle_type == "f":
            for i in range(L - 1):
                restrict(i)
            vc(L - 1, 1)
            for i in range(L - 2, -1, -1):
                prolong(i)
                vc(i, 1)
        else:
            vc(0, {"v": 1, "w": 2}[cfg.cycle_type])

    if cfg.krylov == "pcg":
        for _ in range(cfg.krylov_iters):
            cycle()
            Ax(0)
        if s.plan[0]:
            for _ in range(2 * cfg.krylov_iters):
                t.all_reduce("outer", es)
    else:
        cycle()
    if s.plan[0]:
        if not s.fine_offsets:
            for _ in range(2):
                t.all_gather("outer", es * rows(0))
        elif s.fine_halo:
            H = s.fine_halo
            t.exchange("outer", [(H, H, es), (H, H, es)])
    t.memory("outer", (2 * k_of(0) + 4) * es * rows(0))
    delivery = 2 * es * rows(0) * n if s.plan[0] and n > 1 else 0

    def shape_of(i):
        return (int(s.stats[i][0]),)

    return _bounds(t, L, link_bytes_per_s, hbm_bytes_per_s, cycles, delivery,
                   [dict(r, rows=r["shape"][0]) for r in _level_rows(t, L, shape_of, s.plan)])
