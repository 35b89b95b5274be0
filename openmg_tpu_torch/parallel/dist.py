"""Distributed multigrid: row-partitioned levels over ``torch.distributed``
ranks (twin of ``openmg_tpu/parallel/dist.py``).

Design, as in the JAX package:

* One rank a process, one device a rank.  Every partitioned level's grids
  are cut along axis 0 into contiguous slabs, one a rank, in rank order;
  the static *partition plan* (:func:`partition_plan`) says which levels
  stay partitioned.
* A partitioned level's passes and visits run the halo forms of the stencil
  kernels (:mod:`openmg_tpu_torch.parallel.fast`): the received planes are
  read inside the kernel.  The partitioned transfers take their axis-0 taps
  from one-plane halos (:mod:`openmg_tpu_torch.parallel.halo`).
* Where a level's slab would become too small (or lose factor-2
  divisibility) the cycle *redistributes*: the restricted residual is
  gathered (``all_gather_into_tensor``) and every coarser level runs
  replicated, each rank the same computation through the single-device
  cycle (:func:`~openmg_tpu_torch.core.cycle.v_cycle`, its fused kernels
  included); on the way up each rank slices its rows of the correction.
* Norms and inner products are ``all_reduce`` sums; every rank takes the
  same stopping decision from the same reduced norm.  A solve reads one
  scalar to the host a cycle on each rank, as the single-device loop does.
* The outer step of a dyadic constant fine operator is one launch of K2's
  halo form (the ``(x_hi, x_lo, e)`` planes exchanged in one batch); any
  other fine operator takes the double-float residual in tensor code over
  one-plane halos.

:meth:`DistributedSolver.solve` takes the whole right-hand side on every
rank and returns the whole solution on every rank (gathered at the end).

:meth:`~_RankLoop.solve_many` (both distributed solvers) runs a batch as
one ``(K, *slab)`` stack (:class:`_DistBatch`), as the JAX package runs
its batch as one ``vmap`` over the ``shard_map`` loop: a step of the stack
makes the exchanges of one scalar step, each carrying every member's planes
(partition axis 1), one launch of each kernel's halo form on a batch (K1hb,
K2hb, K3hb, K4hb; K6hb on the sparse engine) a visit, pass or product, the
replicated levels through the single-device cycle on the stack, and one
reduction of the members' norms with one host read.  Every member's
arithmetic is its scalar solve's on the same ranks (every per-member sum is
the scalar call on the member's rows; :class:`~openmg_tpu_torch.parallel.
halo.Comm` reduces each member's as its scalar solve does), so a member is
bit-equal to its scalar distributed solve.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from openmg_tpu_torch.core.config import MeshConfig, SolverConfig
from openmg_tpu_torch.core.cycle import v_cycle
from openmg_tpu_torch.core.hierarchy import Hierarchy
from openmg_tpu_torch.core.solver import (
    _Batch,
    _Checkpointer,
    exact_residual_terms,
    lockstep,
)
from openmg_tpu_torch.ops import kernels
from openmg_tpu_torch.ops.doublefloat import df_add_f32, df_merge, df_mul, df_split, df_sub
from openmg_tpu_torch.ops.stencil import (
    CorneredOperator,
    FacedStencilOperator,
    StencilOperator,
    diag_index,
    shift,
)
from openmg_tpu_torch.ops.transfer import _prolong_axis, _restrict_axis
from openmg_tpu_torch.parallel import fast
from openmg_tpu_torch.parallel.halo import (
    Comm,
    halo_exchange,
    prolong_axis0_ext,
    restrict_axis0_ext,
    shifted_ext,
)
from openmg_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, make_mesh_2d

__all__ = ["partition_plan", "DistributedSolver", "distributed_setup"]


def partition_plan(
    shapes, n_dev: int, min_rows_per_device: int = 2, force: bool = False
) -> tuple:
    """Static per-level partitioned / replicated decision.

    Level ℓ stays partitioned while all of: the previous level is
    partitioned, ``shape0 % n_dev == 0``, the slab is at least
    ``min_rows_per_device`` planes, and the slab's extent is even (so a
    factor-2 restriction never splits a coarse cell between ranks).  The
    coarsest level is always replicated (its direct solve runs on every
    rank).  ``force=True`` (``MeshConfig.force_partition``) marks levels
    partitioned on one rank too, whose halos are then zero planes."""
    plan = []
    prev = True
    for i, shape in enumerate(shapes):
        s0 = int(shape[0])
        ok = (
            prev
            and (n_dev > 1 or force)
            and s0 % n_dev == 0
            and s0 // n_dev >= min_rows_per_device
            and (s0 // n_dev) % 2 == 0
        )
        if i == len(shapes) - 1:
            ok = False
        plan.append(ok)
        prev = ok
    return tuple(plan)


@dataclasses.dataclass(frozen=True)
class LevelVisits:
    """How the cycle runs a level's visit on this rank's slab: static (the
    slab's shape, the operator, the config), built once by the solver
    (:attr:`DistributedSolver.visits`), read by its cycle and by
    :mod:`openmg_tpu_torch.parallel.model`.  A depth is K1h's halo depth
    for that step (:mod:`openmg_tpu_torch.parallel.fast`'s predicates) and
    None where the tier below takes it: K3h / K4h passes, a pass a launch,
    and the tensor transfers.  ``chunks[iters]``: the K1h chunk lengths of
    ``iters`` smoothing iterations (absent: a pass a launch)."""

    pre: int | None = None  # pre-smoothing, residual and restriction
    residual_restrict: int | None = None  # residual and restriction, no stages
    post: int | None = None  # x + P ec and every post-smoothing stage
    post_one: int | None = None  # x + P ec and one post stage (the rest apart)
    chunks: dict = dataclasses.field(default_factory=dict)


def _kind(A):
    if isinstance(A, CorneredOperator):
        return "corner"
    return "const" if A.is_constant else "vary"


def _slab_op(A, lo, hi):
    """The operator of a level restricted to planes ``[lo, hi)``: the same
    taps (and region table) for a constant or cornered level, the slab of
    the coefficient grids for a varying one."""
    shape = (hi - lo,) + tuple(A.grid_shape[1:])
    if isinstance(A, CorneredOperator):
        return dataclasses.replace(A, shape=shape)
    if A.is_constant:
        return StencilOperator(None, A.offsets, A.values, shape)
    return StencilOperator(A.coeffs[:, lo:hi].contiguous(), A.offsets)


def _unfaced(level):
    """A faced level as coefficient grids (the partitioned tier takes
    constant, cornered and varying levels), as in the JAX package."""
    if not isinstance(level.A, FacedStencilOperator):
        return level
    A = level.A.to_varying()
    di = diag_index(A.offsets)
    return dataclasses.replace(level, A=A, inv_diag=1.0 / A.coeff(di))


def _sums(t):
    """Each member's sum of a stack ``(K, ...)``, a ``(K,)`` tensor: the
    scalar ``torch.sum`` on every member's rows (one reduction over the
    stack need not add in that order)."""
    return torch.stack([torch.sum(row) for row in t])


class _DistStep:
    """One right-hand side's outer loop on this rank's slab (of either
    distributed solver, through :meth:`_RankLoop._update`).  ``rn`` is the
    slab's LOCAL sum of ``r_hi²``; the loop reduces it over the ranks
    (:meth:`_RankLoop._norms`)."""

    def __init__(self, solver, b_pair, x_pair):
        self.s, self.b = solver, b_pair
        if x_pair is None:
            z = torch.zeros_like(b_pair[0])
            self.x = (z, z.clone())
            self.r = b_pair[0]
            self.rn = torch.sum(self.r * self.r)
        else:
            self.x = x_pair
            self.r, self.rn = solver._residual_df(b_pair, x_pair)

    def advance(self):
        s = self.s
        self.x, self.r, self.rn = s._update(self.x, self.b, s._inner(self.r))


class _DistBatch(_Batch):
    """The outer loops of a batch on this rank's slabs as one ``(n,
    *slab)`` stack of the members still running: the single-device
    :class:`~openmg_tpu_torch.core.solver._Batch` (narrowing by stacking
    views, frozen members, one host read a step), its step the solver's
    :meth:`_RankLoop._update` on the stack and ``rn`` the members' LOCAL
    sums, reduced over the ranks by :meth:`norms`.  Every rank narrows the
    same members, as it reads the same reduced norms: checked at each
    narrowing."""

    def __init__(self, solver, x, b, r, rn):
        super().__init__(x, b, r, rn, solver._update, solver._inner)
        self.solver = solver

    def norms(self, pending):
        if pending != self.members:
            raise RuntimeError(f"members {pending} read, {self.members} in the batch")
        return self.solver._norms(self.rn)

    def narrow(self, keep):
        if keep != self.members:
            self.solver._same_on_every_rank(keep, len(self.frozen))
        super().narrow(keep)


class _RankLoop:
    """What the two distributed solvers share around their outer loops
    (this one and :class:`~openmg_tpu_torch.parallel.sparse_dist.
    DistributedAlgebraicSolver`): the outer update, the reduction of the
    members' norms, the delivery of the whole solution on every rank, and
    ``solve_many``.  A subclass sets ``comm``, ``plan``, ``grid_shape``,
    ``config``, ``mesh``, ``dtype``, ``_tag`` and ``_fused_terms`` (None
    where the outer step is not K2's) and provides ``_error_solve(r)``,
    ``_residual_df(b, x) -> (r_hi, local Σ r_hi²)`` (on a slab or a
    stack), ``_inputs(b, x0) -> (b_pair, x_pair or None, native)`` and
    ``_info(seconds)``."""

    def _stacked(self, t) -> bool:
        """Whether ``t`` is a stack of members (one axis more than a slab)."""
        return t.ndim == len(self.grid_shape) + 1

    def _inner(self, r):
        return self._error_solve(r.to(self.dtype))

    def _update(self, x, b, e):
        """One outer step's update and residual of the slab (or stack):
        ``(x, r_hi, local Σ r_hi²)``, a member's sum each for a stack.
        K2's halo form (K2hb on a stack) where the fine operator takes it,
        its ``(x_hi, x_lo, e)`` planes in one exchange; else ``x + e`` in
        double-float and :meth:`_residual_df`."""
        if self._fused_terms is None:
            x = df_add_f32(x, e)
            return (x, *self._residual_df(b, x))
        axis = int(self._stacked(e))
        planes = self.comm.exchange([(t, 1, 1) for t in (x[0], x[1], e)], axis)
        run = kernels.df_update_residual_batch if axis else kernels.df_update_residual_const_3d
        xh, xl, r, pn = run(self._fine_offsets, self._fused_terms, x[0], x[1], e,
                            b[0], b[1], emit_norm=True, halos=tuple(planes))
        return (xh, xl), r, _sums(pn) if axis else torch.sum(pn)

    def _norms(self, rns):
        """The members' ‖r‖ from their local sums (a list of 0-d tensors,
        or a stack's ``(n,)``): one host read, each member's sum over the
        ranks as its scalar solve's."""
        sums = torch.stack(rns) if isinstance(rns, list) else rns
        total = self.comm.host_sums(sums, members=True) if self.plan[0] else sums.cpu()
        return total.double().sqrt().tolist()

    def _same_on_every_rank(self, keep, K):
        """Raise unless every rank keeps the members ``keep`` of ``K``."""
        if not self.plan[0]:
            return
        mask = torch.zeros(K, dtype=torch.float64, device=self.comm.device)
        mask[list(keep)] = 1.0
        both = torch.cat([mask, -mask])
        if not torch.equal(self.comm.all_max(both), both):
            raise RuntimeError(f"the ranks keep different members of the batch: {keep} here")

    def _gather(self, t):
        """The whole fine grid (a stack's: each member's) from every rank's
        slab."""
        if not self.plan[0]:
            return t
        return self.comm.all_gather(t.contiguous(), int(self._stacked(t)))

    def _deliver(self, x_pair, native, info, lead=()):
        """The whole solution on every rank: float64 numpy (the exact merge
        of the pair) for a host caller; for a float32 tensor caller the hi
        part on the device, the pair in ``info['x_df']``.  ``lead``:
        ``(K,)`` for a stack."""
        xh, xl = (self._gather(t) for t in x_pair)
        shape = tuple(lead) + tuple(self.grid_shape)
        if native:
            info["x_df"] = (xh.reshape(shape), xl.reshape(shape))
            return info["x_df"][0]
        return df_merge((xh, xl)).reshape(shape)

    def _step(self, b, x0):
        b_pair, x_pair, native = self._inputs(b, x0)
        return _DistStep(self, b_pair, x_pair), native

    def _batch(self, members, x0s):
        """The outer loops of ``members`` from ``x0s`` as one
        :class:`_DistBatch`, started as each member's scalar step starts:
        ``r = b`` from zero, the double-float residual from an ``x0`` (of
        the members given one, as one stack)."""
        ins = [self._inputs(b, x0) for b, x0 in zip(members, x0s)]
        b = tuple(torch.stack([i[0][j] for i in ins]) for j in (0, 1))
        zero = torch.zeros_like(b[0][0])
        x = tuple(torch.stack([zero if i[1] is None else i[1][j] for i in ins])
                  for j in (0, 1))
        r, rn = b[0], _sums(b[0] * b[0])
        given = [m for m, i in enumerate(ins) if i[1] is not None]
        if given:
            def pick(t):
                return torch.stack([t[m] for m in given])

            r_x, rn_x = self._residual_df(tuple(map(pick, b)), tuple(map(pick, x)))
            at = {m: p for p, m in enumerate(given)}
            r = torch.stack([r_x[at[m]] if m in at else r[m] for m in range(len(ins))])
            rn = torch.stack([rn_x[at[m]] if m in at else rn[m] for m in range(len(ins))])
        return _DistBatch(self, x, b, r, rn)

    def solve_many(self, bs, x0s=None):
        """A batch of right-hand sides as one stack (:class:`_DistBatch`):
        every step advances the members not yet converged in one outer step
        of the stack (the exchanges of one scalar step, each with every
        member's planes; a launch of each kernel's batched halo form) and
        reduces their norms in one reduction and one host read.  Returns
        ``(xs, info)`` stacked as :meth:`solve` returns one (whole grids on
        every rank: stacked float64 numpy, or for a float32 tensor batch on
        the solver's device its hi parts with the pairs in
        ``info['x_df']``), with per-member ``cycles``, ``converged``,
        ``final_norm`` and ``residual_norms``.  Each member is bit-equal to
        its scalar :meth:`solve` on the same ranks."""
        cfg = self.config
        shape = self.grid_shape
        native = isinstance(bs, torch.Tensor) and bs.dtype == torch.float32
        members = list(bs.reshape((bs.shape[0],) + tuple(shape))) if native else list(bs)
        K = len(members)
        if x0s is None:
            x0s = [None] * K
        elif len(x0s) != K:
            raise ValueError(f"{len(x0s)} initial guesses for {K} right-hand sides")
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        t_start = time.perf_counter()
        batch = self._batch(members, x0s)
        histories, converged, _, reads = lockstep(
            list(range(K)), limit, float(cfg.threshold),
            lambda i, k, v: self._say(i, k, v, batch=True),
            norms=batch.norms, advance=batch.advance,
        )
        info = {
            "batch": K,
            "cycles": [len(h) - 1 for h in histories],
            "converged": converged,
            "final_norm": [h[-1] for h in histories],
            "residual_norms": histories,
            **self._info(time.perf_counter() - t_start),
            "host_reads": reads,
        }
        return self._deliver(batch.iterates(), native, info, (K,)), info

    def _say(self, i, k, rnorm, batch=False):
        if self.config.verbose and self.mesh.index == 0:
            who = f" rhs {i}" if batch else ""
            print(f"[openmg_tpu_torch/{self._tag}]{who} cycle {k}: ‖r‖ = {rnorm:.3e}")


class DistributedSolver(_RankLoop):
    """Multi-rank solver: the contract of
    :class:`~openmg_tpu_torch.core.solver.Solver`, with every partitioned
    level cut into slabs over the ranks.  Only the double-float outer
    residual is offered, as in the JAX package.

    Scope, checked here: every partitioned level's operator reaches one
    plane across a slab boundary (radius 1 on axis 0), true of the
    Poisson/Galerkin family; the finest level must be partitionable over
    more than one rank.  ``hierarchy`` is the whole hierarchy on this
    rank's ``device``; each rank keeps its slabs of the partitioned levels
    and the whole of the replicated ones.
    """

    def __init__(
        self,
        hierarchy: Hierarchy,
        config: SolverConfig,
        mesh_config: MeshConfig | None = None,
        device=None,
    ):
        if hierarchy.fine_hi_lo is None:
            raise ValueError(
                "distributed solver requires residual_dtype='doublefloat'"
            )
        if config.cycle_type not in ("v", "w", "f"):
            raise ValueError(f"unknown cycle_type {config.cycle_type!r}; choose v|w|f")
        if config.krylov not in (None, "none", "pcg"):
            raise ValueError(f"unknown krylov {config.krylov!r}; choose none|pcg")
        if any(isinstance(l.A, FacedStencilOperator) for l in hierarchy.levels):
            hierarchy = dataclasses.replace(
                hierarchy, levels=tuple(_unfaced(l) for l in hierarchy.levels)
            )
        self.hierarchy = hierarchy
        self.config = config
        self._tag = "dist"
        self.device = torch.device(device) if device is not None else hierarchy.device
        self.dtype = torch.float32
        self.mesh_config = mc = mesh_config or MeshConfig()
        if mc.mesh_shape is not None:
            self.mesh = make_mesh_2d(mc.mesh_shape, mc.axis_names)
        else:
            self.mesh = make_mesh(mc.n_devices, mc.axis_name)
        if self.mesh.index < 0:
            raise ValueError(
                f"rank {dist.get_rank()} is not in the mesh of {self.mesh.size} ranks"
            )
        self.comm = Comm(self.mesh, self.device)
        self.n_dev = self.mesh.size
        shapes = [tuple(s[0]) for s in hierarchy.stats]
        self.plan = partition_plan(
            shapes, self.n_dev, mc.min_rows_per_device, force=mc.force_partition
        )
        if not self.plan[0] and self.n_dev > 1:
            raise ValueError(
                f"finest level shape {shapes[0]} cannot be row-partitioned "
                f"over {self.n_dev} ranks (axis 0 must divide evenly with "
                f">= {2 * mc.min_rows_per_device} rows a rank)"
            )
        self.grid_shape = shapes[0]
        self.stats = hierarchy.stats
        self.transfer = hierarchy.transfer
        for i, l in enumerate(hierarchy.levels):
            if self.plan[i] and any(abs(o[0]) > 1 for o in l.A.offsets):
                raise ValueError(
                    f"level {i} operator reaches more than one plane across the "
                    "partition boundary; the halo exchange takes radius 1 only"
                )
        self.kinds = tuple(_kind(l.A) for l in hierarchy.levels)
        self.coarsened_axes = tuple(
            tuple(
                a for a in range(len(shapes[i]))
                if shapes[i + 1][a] * 2 == shapes[i][a]
            )
            for i in range(len(shapes) - 1)
        ) + ((),)
        # the rank's rows of every partitioned level
        self.rows = []
        self.ops, self.inv_diags = [], []
        for i, l in enumerate(hierarchy.levels):
            n0 = shapes[i][0]
            loc = n0 // self.n_dev if self.plan[i] else n0
            lo = self.mesh.index * loc if self.plan[i] else 0
            self.rows.append((lo, lo + loc))
            if self.plan[i]:
                self.ops.append(_slab_op(l.A, lo, lo + loc))
                inv = l.inv_diag
                self.inv_diags.append(inv if inv.ndim == 0 else inv[lo:lo + loc].contiguous())
            else:
                self.ops.append(l.A)
                self.inv_diags.append(l.inv_diag)
        lo0, hi0 = self.rows[0]
        self.fine_hi = _slab_op(hierarchy.fine_hi, lo0, hi0)
        self.fine_lo = _slab_op(hierarchy.fine_hi_lo, lo0, hi0)
        self._fine_offsets = hierarchy.fine_hi.offsets
        self._exact_terms = exact_residual_terms(hierarchy)
        local0 = (hi0 - lo0,) + tuple(self.grid_shape[1:])
        self._fused_terms = (
            self._exact_terms
            if self._exact_terms is not None and hierarchy.fine_hi.is_constant
            and len(local0) == 3
            else None
        )
        self.gamma = {"v": 1, "w": 2, "f": 1}[config.cycle_type]
        self.visits = tuple(self._visits(i) for i in range(len(shapes)))

    # -- the cycle ---------------------------------------------------------

    def _deep(self, level) -> bool:
        """A partitioned constant or cornered 3D level whose coarser level
        is partitioned too, every axis coarsening: K1's halo form takes
        its visits."""
        return (
            self.plan[level] and self.plan[level + 1]
            and self.kinds[level] in ("const", "corner")
            and self.coarsened_axes[level] == (0, 1, 2)
        )

    def slab_shape(self, level):
        """The shape of this rank's slab of ``level`` (the whole grid where
        the level is replicated)."""
        shape = tuple(int(v) for v in self.stats[level][0])
        return (shape[0] // self.n_dev if self.plan[level] else shape[0],) + shape[1:]

    def _visits(self, level) -> LevelVisits:
        """The level's :class:`LevelVisits` (empty where it is replicated)."""
        if not self.plan[level]:
            return LevelVisits()
        cfg, op, tr = self.config, self.ops[level], self.transfer
        sm, om, pre, post = cfg.smoother, cfg.omega, cfg.pre_iterations, cfg.post_iterations
        shape, dt = self.slab_shape(level), self.dtype
        chunks = {}
        for it in {pre, post, post - 1}:
            sizes = fast.chunk_sizes(sm, op, shape, dt, it, om) if it > 0 else None
            if sizes:
                chunks[it] = sizes
        if not self._deep(level):
            return LevelVisits(chunks=chunks)
        coarse = self.slab_shape(level + 1)[0]
        return LevelVisits(
            pre=fast.presmooth_depth(sm, op, shape, dt, pre, om, tr) if pre > 0 else None,
            residual_restrict=fast.residual_restrict_depth(op, shape, dt, tr),
            post=(fast.prolong_depth(sm, op, shape, coarse, dt, post, om, tr)
                  if post > 0 else None),
            post_one=(fast.prolong_depth(sm, op, shape, coarse, dt, 1, om, tr)
                      if post > 1 else None),
            chunks=chunks,
        )

    def _smooth(self, level, b, x, iters):
        if iters <= 0:
            return x
        cfg, op, comm = self.config, self.ops[level], self.comm
        sizes = self.visits[level].chunks.get(iters)
        if sizes:
            return fast.smooth_chunks_part(cfg.smoother, op, b, x, iters, cfg.omega,
                                           comm, sizes)
        if self.kinds[level] in ("const", "corner"):
            return fast.smooth_part(cfg.smoother, op, b, x, iters, cfg.omega, comm)
        return fast.smooth_part_vary(
            cfg.smoother, op, self.inv_diags[level], b, x, iters, cfg.omega, comm
        )

    def _residual(self, level, b, x):
        op = self.ops[level]
        if self.kinds[level] in ("const", "corner"):
            return fast.residual_part(op, b, x, self.comm)
        return fast.residual_part_vary(op, b, x, self.comm)

    def _lead(self, level, t) -> int:
        """Leading axes of ``t`` before level ``level``'s grid: 1 for a
        stack of members (the level's dimension decides), else 0.  A
        stack's partition axis is axis 1."""
        return t.ndim - len(self.stats[level][0])

    def _restrict(self, level, r):
        """Level → level + 1, axis 0 by halo taps on a partitioned level;
        the gather at the partitioned → replicated transition."""
        taps = self.transfer.r_taps
        k = self._lead(level, r)
        out = r
        for a in self.coarsened_axes[level]:
            if a == 0 and self.plan[level]:
                out = restrict_axis0_ext(halo_exchange(out, self.comm, k), taps, k)
            else:
                out = _restrict_axis(out, a + k, taps)
        if self.plan[level] and not self.plan[level + 1]:
            out = self.comm.all_gather(out, k)
        return out

    def _prolong(self, level, ec):
        """Level + 1 → level: halo taps between partitioned levels; the
        whole prolongation and this rank's rows below a replicated level."""
        taps = self.transfer.p_taps
        axes = self.coarsened_axes[level]
        k = self._lead(level + 1, ec)
        up = ec
        if self.plan[level] and self.plan[level + 1]:
            for a in reversed(axes):
                if a == 0:
                    up = prolong_axis0_ext(halo_exchange(up, self.comm, k), taps, k)
                else:
                    up = _prolong_axis(up, a + k, taps)
            return up
        for a in reversed(axes):
            up = _prolong_axis(up, a + k, taps)
        if self.plan[level]:
            lo, hi = self.rows[level]
            up = up.narrow(k, lo, hi - lo).contiguous()
        return up

    def _vc(self, level, b, x, x_zero=False):
        """One µ-cycle from ``level`` on this rank's slabs."""
        cfg, comm = self.config, self.comm
        h = self.hierarchy
        pre, post, sm, om = (
            cfg.pre_iterations, cfg.post_iterations, cfg.smoother, cfg.omega
        )
        if not self.plan[level]:
            # replicated from here down: every rank runs the single-device
            # cycle on the same data
            return v_cycle(h, b, x, level, pre, post, sm, om, self.gamma,
                           x_zero=x_zero)
        op, tr, plan = self.ops[level], self.transfer, self.visits[level]
        if plan.pre is not None:
            x, bc = fast.presmooth_restrict_part(
                sm, op, b, None if x_zero else x, pre, om, tr, comm, plan.pre
            )
        else:
            if x_zero or x is None:
                x = torch.zeros_like(b)
            x = self._smooth(level, b, x, pre)
            if plan.residual_restrict is not None:
                bc = fast.residual_restrict_part(op, b, x, tr, comm, plan.residual_restrict)
            else:
                bc = self._restrict(level, self._residual(level, b, x))
        visits = 1 if level == h.num_levels - 2 else self.gamma
        ec = None
        for v in range(visits):
            ec = self._vc(level + 1, bc, ec, x_zero=(v == 0))
        if plan.post is not None:
            return fast.prolong_smooth_part(sm, op, b, x, ec, post, om, tr, comm, plan.post)
        if plan.post_one is not None:
            y = fast.prolong_smooth_part(sm, op, b, x, ec, 1, om, tr, comm, plan.post_one)
            return self._smooth(level, b, y, post - 1)
        x = x + self._prolong(level, ec)
        return self._smooth(level, b, x, post)

    def _fmg(self, r):
        """Full multigrid: the rhs restricted to every level with the
        cycle's transfers (and its gather), the coarsest solved exactly,
        then a µ-cycle a level upward from the prolonged iterate."""
        h = self.hierarchy
        bs = [r]
        for level in range(h.num_levels - 1):
            bs.append(self._restrict(level, bs[-1]))
        x = self._vc(h.num_levels - 1, bs[-1], None, x_zero=True)
        for level in range(h.num_levels - 2, -1, -1):
            x = self._prolong(level, x)
            x = self._vc(level, bs[level], x)
        return x

    def _cycle(self, r):
        if self.config.cycle_type == "f":
            return self._fmg(r)
        return self._vc(0, r, None, x_zero=True)

    def _apply_A(self, p):
        """``A p`` on the fine slab: ``−(0 − A p)`` through the partitioned
        residual kernels."""
        if not self.plan[0]:
            from openmg_tpu_torch.ops.stencil import apply as stencil_apply

            return stencil_apply(self.ops[0], p)
        return -self._residual(0, torch.zeros_like(p), p)

    def _pdot(self, a, b):
        """``a·b`` over the ranks; on a stack each member's, shaped to
        broadcast against it."""
        if not self._stacked(a):
            s = torch.sum(a * b)
            return self.comm.all_reduce(s) if self.plan[0] else s
        s = _sums(a * b)
        s = self.comm.all_reduce(s, members=True) if self.plan[0] else s
        return s.reshape((-1,) + (1,) * (a.ndim - 1))

    def _pcg(self, r0):
        """``krylov_iters`` CG steps on ``A e = r0`` from zero, each
        preconditioned by one cycle; the inner products are ``all_reduce``
        sums (device tensors, never read to the host under NCCL)."""
        iters = self.config.krylov_iters
        e = torch.zeros_like(r0)
        r = r0
        z = self._cycle(r)
        p = z
        rz = self._pdot(r, z)
        for it in range(iters):
            Ap = self._apply_A(p)
            alpha = rz / self._pdot(p, Ap)
            e = e + alpha * p
            if it == iters - 1:
                break
            r = r - alpha * Ap
            z = self._cycle(r)
            rz_new = self._pdot(r, z)
            beta = rz_new / rz
            rz = rz_new
            p = z + beta * p
        return e

    def _error_solve(self, r):
        if self.config.krylov == "pcg":
            return self._pcg(r)
        return self._cycle(r)

    # -- the outer loop ----------------------------------------------------

    def _residual_df(self, b_pair, x_pair):
        """Double-float ``r = b − A x`` on the fine slab (tensor code over
        one-plane halos) and its local ``Σ r_hi²`` (each member's on a
        stack)."""
        offsets = self._fine_offsets
        xh, xl = x_pair
        k = int(self._stacked(xh))
        if self.plan[0]:
            eh, el = (halo_exchange(t, self.comm, k) for t in (xh, xl))
            samples = [(shifted_ext(eh, o, k), shifted_ext(el, o, k)) for o in offsets]
        else:
            samples = [(shift(xh, o), shift(xl, o)) for o in offsets]
        acc = b_pair
        for j, xs in enumerate(samples):
            if self._exact_terms is not None:
                for p in self._exact_terms[j]:
                    acc = df_sub(acc, (float(p) * xs[0], float(p) * xs[1]))
            else:
                acc = df_sub(acc, df_mul((self.fine_hi.coeff(j), self.fine_lo.coeff(j)), xs))
        sq = acc[0] * acc[0]
        return acc[0], _sums(sq) if k else torch.sum(sq)

    def _local(self, a):
        """This rank's rows of a whole fine grid (numpy float64 or a tensor
        on the rank's device)."""
        lo, hi = self.rows[0]
        return a[lo:hi]

    def _inputs(self, b, x0):
        """One member's ``(b_pair, x_pair or None, native)`` on this rank's
        slab."""
        shape = self.grid_shape
        native = isinstance(b, torch.Tensor) and b.dtype == torch.float32
        if native:
            if b.device != self.device:
                raise ValueError(f"b is on {b.device} but the solver is on {self.device}")
            bh = self._local(b.reshape(shape)).contiguous()
            b_pair = (bh, torch.zeros_like(bh))
        else:
            if isinstance(b, torch.Tensor):
                b = b.detach().cpu().numpy()
            b_np = self._local(np.asarray(b, dtype=np.float64).reshape(shape))
            b_pair = df_split(np.ascontiguousarray(b_np), self.device)
        x_pair = None
        if x0 is not None:
            if isinstance(x0, torch.Tensor):
                x0 = x0.detach().cpu().numpy()
            x_np = self._local(np.asarray(x0, dtype=np.float64).reshape(shape))
            x_pair = df_split(np.ascontiguousarray(x_np), self.device)
        return b_pair, x_pair, native

    def _info(self, solve_time):
        return {
            "gridlevels": self.hierarchy.num_levels,
            "level_stats": self.stats,
            "transfer": self.transfer.name,
            "residual_mode": "doublefloat",
            "partition_plan": self.plan,
            "n_devices": self.n_dev,
            "transport": self.comm.transport,
            "outer_loop": "host",
            "solve_time_s": solve_time,
        }

    def solve(self, b, x0=None, *, checkpoint_path=None, checkpoint_every: int = 1,
              resume: bool = False):
        """Solve ``A x = b``; ``b`` (and ``x0``) are the whole grid on every
        rank.  Same contract as
        :meth:`~openmg_tpu_torch.core.solver.Solver.solve`, checkpoint/
        resume included: the iterate is gathered for a write and the first
        rank writes it; every rank reads it on resume."""
        cfg = self.config
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        t_start = time.perf_counter()
        ckpt = _Checkpointer(
            checkpoint_path, checkpoint_every, resume, cfg, self.grid_shape,
            write=self.mesh.index == 0,
        )
        if ckpt.x0 is not None:
            x0 = ckpt.x0
        step, native = self._step(b, x0)

        def after(_, hist):
            ckpt.save(lambda: df_merge(tuple(self._gather(t) for t in step.x))
                      .reshape(self.grid_shape), hist)

        (history,), (converged,), _, reads = lockstep(
            [step], limit - ckpt.start, float(cfg.threshold), self._say,
            after if checkpoint_path is not None else None, self._norms,
        )
        history = ckpt.history + history
        solve_time = time.perf_counter() - t_start
        k = len(history) - 1
        info = {
            "residual_norms": history,
            "cycles": k,
            "converged": bool(converged),
            "final_norm": history[-1],
            **self._info(solve_time),
            "mean_cycle_time_s": solve_time / max(k, 1),
            "host_reads": reads + ckpt.writes,
        }
        return self._deliver(step.x, native, info), info

def rank_device(device=None):
    """A rank's device: ``cuda:{LOCAL_RANK}`` for None or an unnumbered
    ``"cuda"`` (a rank's own card; never the CPU by itself), else
    ``device``."""
    device = _default_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def _default_device():
    """``cuda:{LOCAL_RANK}``: a rank's own card.  Never the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the distributed solver runs on the GPU by default; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def distributed_setup(
    problem,
    config: SolverConfig | None = None,
    mesh_config: MeshConfig | None = None,
    *,
    device=None,
) -> DistributedSolver:
    """Build a :class:`DistributedSolver` on this rank.

    ``device``: ``cuda:{LOCAL_RANK}`` when None (never the CPU by itself);
    ``"cpu"`` for CPU ranks, or ``"cuda:0"`` for ranks that share one card.
    Joins the process group first if this process has not (from the
    environment ``torchrun`` sets; a lone process is a world of one).
    """
    from openmg_tpu_torch.core.solver import setup

    device = rank_device(device)
    if not dist.is_initialized():
        initialize_distributed(device=device)
    config = config or SolverConfig(residual_dtype="doublefloat")
    if config.residual_dtype != "doublefloat":
        config = dataclasses.replace(config, residual_dtype="doublefloat")
    base = setup(problem, config, faced=True, device=device)
    return DistributedSolver(base.hierarchy, config, mesh_config, device)
