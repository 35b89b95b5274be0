"""Distributed general-sparse multigrid: ELL levels row-partitioned over
``torch.distributed`` ranks (twin of ``openmg_tpu/parallel/sparse_dist.py``).

Design, as in the JAX package:

* One rank a process, one device a rank.  A partitioned level's rows are
  cut into contiguous blocks, one a rank, in rank order; the static plan
  (:func:`sparse_partition_plan`) says which levels are partitioned.  Each
  rank holds only its row block of every partitioned level (slot planes,
  inverse diagonal, colours, and its rows of the transfer matrices) and the
  whole of the replicated ones, the coarsest always among them.
* **Banded levels** (``slot_offsets`` set: every slot ``j`` a constant
  column offset ``d_j``) multiply on a block of ``m`` rows with ``H =
  max|d_j|`` rows received from each neighbour
  (:meth:`~openmg_tpu_torch.parallel.halo.Comm.exchange`, one batch an
  ``Ax``): ``y[i] = Σ_j data[j, i] · xe[i + d_j + H]``, ``xe = [lo | x |
  hi]``, which is one launch of K6's halo form on the card
  (:func:`openmg_tpu_torch.ops.ell.spmv_banded_halo`, K6h).  A replicated
  banded level launches K6 as it is.
* **Irregular levels** partition on the *gathered-x tier*: every ``Ax``
  all-gathers the source vector, then gathers the block's rows by their
  global column ids, as the single-device engine does for an irregular ELL.
* **Transfers** gather the source vector when its level is partitioned,
  then run the single-device transfer (the separable grid ops of a factor-2
  level pair, or the rank's row block of R / P) and keep the rank's rows.
* Smoothing (Jacobi, multicolour GS with one exchange a colour, Chebyshev),
  the V/W/FMG cycle, MG-PCG (inner products by ``all_reduce``) and the
  outer double-float residual (tensor code over one batch of ``(x_hi,
  x_lo)`` H-row slabs) follow the single-device engine's arithmetic
  (:mod:`openmg_tpu_torch.core.algebraic`) term by term, so only the norms'
  sums differ from it.
* The outer loop is the host loop of the single-device engines
  (:func:`openmg_tpu_torch.core.solver.lockstep`): one inner solve, one
  residual and one scalar read a cycle on each rank, every rank taking the
  same decision from the same reduced norm.

``MeshConfig(force_partition=True)`` keeps the levels partitioned on one
rank (zero halos, gathers the identity): the per-rank program of a larger
mesh on one card.

``solve_many`` runs its batch as one ``(K, m)`` stack of the ranks' rows
(:class:`~openmg_tpu_torch.parallel.dist._DistBatch`, shared with the
stencil engine): a banded ``Ax`` is one exchange of the stack's rows and
one launch of K6hb, a replicated one K6b (or K7b), the transfers gather the
stack once; the gathered tier's row gathers and sums, and the coarsest
product, run member by member on the gathered stack (a sum over the stack's
slots need not add in the scalar call's order, and a matrix product over
the batch need not keep each column's bits).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from openmg_tpu_torch.core.algebraic import (
    SparseHierarchy,
    _prolong_level,
    _restrict_level,
)
from openmg_tpu_torch.core.config import MeshConfig, SolverConfig
from openmg_tpu_torch.core.solver import lockstep
from openmg_tpu_torch.ops import ell
from openmg_tpu_torch.ops.doublefloat import df_add, df_mul, df_split, df_sub
from openmg_tpu_torch.ops.sparse import ELLMatrix, matvec_full, spmv, spmv_df
from openmg_tpu_torch.parallel.dist import _RankLoop, _sums, rank_device
from openmg_tpu_torch.parallel.halo import Comm
from openmg_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, make_mesh_2d

__all__ = [
    "sparse_partition_plan",
    "DistributedAlgebraicSolver",
    "setup_sparse_distributed",
]


# ---------------------------------------------------------------------------
# partition plan
# ---------------------------------------------------------------------------


def sparse_partition_plan(
    hierarchy: SparseHierarchy,
    n_dev: int,
    min_rows_per_device: int = 2,
    force: bool = False,
) -> tuple:
    """Which levels run row-partitioned (True) or replicated (False).

    An ELL level other than the coarsest is partitioned when its rows
    divide over ``n_dev`` ranks and a block holds at least
    ``max(H, min_rows_per_device)`` rows (a banded level, ``H`` its band
    halo, so a halo is one neighbour's rows) or ``min_rows_per_device``
    rows (an irregular level: the gathered-x tier).  The fine level also
    needs a block of at least the band halo of the outer residual's
    operator.  ``force=True`` (``MeshConfig.force_partition``) keeps the
    levels partitioned on one rank."""
    L = hierarchy.num_levels
    plan = []
    for i, l in enumerate(hierarchy.levels):
        ok = (
            (n_dev > 1 or force)
            and i < L - 1
            and isinstance(l.A, ELLMatrix)
            and l.n % n_dev == 0
        )
        if ok:
            m = l.n // n_dev
            if l.A.slot_offsets is not None:
                ok = m >= max(ell.band_halo(l.A.slot_offsets), min_rows_per_device, 1)
            else:
                ok = m >= max(min_rows_per_device, 1)
        if ok and i == 0:
            fh = hierarchy.fine_hi
            if fh.slot_offsets is not None:
                ok = l.n // n_dev >= ell.band_halo(fh.slot_offsets)
        plan.append(bool(ok))
    return tuple(plan)


# ---------------------------------------------------------------------------
# the rank's share of a level
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Level:
    """One level as a rank holds it: ``data`` the slot planes of its rows
    (all rows when replicated), ``cols`` their global column ids (irregular
    levels only), ``whole`` the level's matrix (replicated levels: the
    single-device product), and the smoother's data of its rows (``colors``
    only under multicolour GS).  ``tier`` and ``sweeps`` say what an ``Ax``
    and a smoothing iteration exchange; the solver dispatches on them and
    :mod:`openmg_tpu_torch.parallel.model` counts from them."""

    part: bool
    offsets: tuple | None
    halo: int
    data: torch.Tensor | None
    cols: torch.Tensor | None
    whole: ELLMatrix | None
    inv_diag: torch.Tensor
    colors: torch.Tensor | None
    num_colors: int
    lam_max: torch.Tensor | None

    @property
    def tier(self) -> str:
        """How an ``Ax`` runs: ``"replicated"`` (the single-device product,
        K6 on a banded level), ``"gathered"`` (the source all-gathered, then
        the block's rows by their column ids) or ``"banded"`` (K6h after
        one exchange of ``halo`` rows each way, none where ``halo`` is 0)."""
        if not self.part:
            return "replicated"
        return "gathered" if self.offsets is None else "banded"

    @property
    def sweeps(self) -> int:
        """The ``Ax`` products of a Jacobi or GS iteration: one a colour
        under multicolour GS, else one."""
        return self.num_colors if self.colors is not None else 1


def _rows(t, lo, hi, device):
    """Rows ``[lo, hi)`` of a vector or of ``(k, n)`` slot planes, on
    ``device``."""
    return t[..., lo:hi].contiguous().to(device)


def _row_block(M: ELLMatrix, lo, hi, device) -> ELLMatrix:
    """Rows ``[lo, hi)`` of a (rectangular) ELL matrix, global columns."""
    return ELLMatrix(
        data=_rows(M.data, lo, hi, device), cols=_rows(M.cols, lo, hi, device),
        shape=(hi - lo, M.shape[1]), nnz=M.nnz, bandwidth=M.bandwidth,
        slot_offsets=None,
    )


def _on(M: ELLMatrix, device) -> ELLMatrix:
    return dataclasses.replace(M, data=M.data.to(device), cols=M.cols.to(device))


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


class DistributedAlgebraicSolver(_RankLoop):
    """Multi-rank general-sparse solver: the contract of
    :class:`~openmg_tpu_torch.core.algebraic.AlgebraicSolver` (``solve``
    with ``x0``, ``solve_many``), with ELL levels row-partitioned over the
    ranks of a 1D or ``(host, chip)`` mesh (module docstring).

    Requirements, checked here: an ELL hierarchy, the double-float outer
    residual, and a fine level that partitions over the mesh.
    ``krylov='pcg'`` runs MG-preconditioned CG with ``all_reduce`` inner
    products.  ``hierarchy`` may lie on any device (the host, as
    :func:`setup_sparse_distributed` builds it); this rank's share of it is
    copied to ``device`` (the hierarchy's when None).
    """

    def __init__(
        self,
        hierarchy: SparseHierarchy,
        config: SolverConfig,
        mesh_config: MeshConfig | None = None,
        device=None,
    ):
        if hierarchy.fmt != "ell":
            raise ValueError(
                f"format={hierarchy.fmt!r}: the distributed general-sparse "
                "engine runs on ELL hierarchies (banded slot-offset "
                "partitioning); build with format='ell' or solve "
                "single-device"
            )
        if hierarchy.fine_lo is None:
            raise ValueError(
                "distributed solver requires residual_dtype='doublefloat'"
            )
        if config.krylov not in (None, "none", "pcg"):
            raise ValueError(f"unknown krylov {config.krylov!r}; choose none|pcg")
        if config.cycle_type not in ("v", "w", "f"):
            raise ValueError(f"unknown cycle_type {config.cycle_type!r}; choose v|w|f")
        if config.smoother not in ("jacobi", "rbgs", "chebyshev"):
            raise ValueError(f"unknown smoother {config.smoother!r}")
        self.hierarchy = hierarchy
        self.config = config
        self._tag = "sparse-dist"
        self.device = torch.device(device) if device is not None else hierarchy.device
        self.dtype = hierarchy.levels[0].inv_diag.dtype
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
        self.plan = sparse_partition_plan(
            hierarchy, self.n_dev, mc.min_rows_per_device, force=mc.force_partition
        )
        if not self.plan[0] and self.n_dev > 1:
            l0 = hierarchy.levels[0]
            raise ValueError(
                f"finest level cannot be row-partitioned: {l0.n} rows do "
                f"not split over {self.n_dev} devices with >= "
                f"max(halo, {mc.min_rows_per_device}) "
                "rows/device; solve single-device (core.algebraic) instead"
            )
        self.n = hierarchy.n
        self.grid_shape = (self.n,)
        L = hierarchy.num_levels
        # every banded level's offsets: a replicated banded level takes K6,
        # never a gather
        self.offsets_per_level = tuple(
            tuple(int(d) for d in l.A.slot_offsets)
            if isinstance(l.A, ELLMatrix) and l.A.slot_offsets is not None
            else None
            for l in hierarchy.levels
        )
        self.halos_per_level = tuple(
            ell.band_halo(o) if o is not None else 0 for o in self.offsets_per_level
        )
        self.num_colors = tuple(l.num_colors for l in hierarchy.levels)
        self._geoms = tuple(hierarchy.geom_transfer(i) for i in range(L - 1))
        fh = hierarchy.fine_hi
        self.fine_offsets = tuple(int(d) for d in fh.slot_offsets or ())
        self.fine_halo = ell.band_halo(self.fine_offsets)
        self.stats = hierarchy.stats

        # ---- this rank's share of the hierarchy ---------------------------
        dev = self.device
        self.rows = []
        levels = []
        for i, l in enumerate(hierarchy.levels):
            part = self.plan[i]
            m = l.n // self.n_dev if part else l.n
            lo = self.mesh.index * m if part else 0
            self.rows.append((lo, lo + m))
            offs = self.offsets_per_level[i]
            levels.append(_Level(
                part=part, offsets=offs, halo=self.halos_per_level[i],
                data=_rows(l.A.data, lo, lo + m, dev) if part else None,
                cols=(_rows(l.A.cols, lo, lo + m, dev)
                      if part and offs is None else None),
                whole=None if part else _on(l.A, dev),
                inv_diag=_rows(l.inv_diag, lo, lo + m, dev),
                colors=(_rows(l.colors, lo, lo + m, dev)
                        if config.smoother == "rbgs" and l.colors is not None
                        else None),
                num_colors=l.num_colors,
                lam_max=None if l.lam_max is None else l.lam_max.to(dev),
            ))
        self.levels = tuple(levels)
        # the transfers: the single-device ones (core.algebraic) on a
        # hierarchy whose R / P are this rank's rows (level i + 1's rows of
        # R, level i's of P), kept only where a pair has no grid transfer
        xfer = []
        for i, l in enumerate(hierarchy.levels):
            R = P = None
            if i < L - 1 and self._geoms[i] is None:
                R = _row_block(l.R, *self.rows[i + 1], dev)
                P = _row_block(l.P, *self.rows[i], dev)
            xfer.append(dataclasses.replace(l, R=R, P=P))
        self._xfer = dataclasses.replace(hierarchy, levels=tuple(xfer))
        self.coarse_inv = hierarchy.coarse_inv.to(dev)
        lo0, hi0 = self.rows[0]
        if self.plan[0]:
            self.fine_hi = _rows(fh.data, lo0, hi0, dev)
            self.fine_lo = _rows(hierarchy.fine_lo.data, lo0, hi0, dev)
            self.fine_cols = (None if self.fine_offsets
                              else _rows(fh.cols, lo0, hi0, dev))
        else:
            self.fine_hi, self.fine_lo = _on(fh, dev), _on(hierarchy.fine_lo, dev)
            self.fine_cols = None
        self.gamma = {"v": 1, "w": 2, "f": 1}[config.cycle_type]
        # the outer step is the update and the double-float residual (no K2)
        self._fused_terms = None

    # -- level products ----------------------------------------------------

    def _full(self, v, part):
        """The whole vector of a level from every rank's rows (each
        member's, for a stack ``(K, m)``)."""
        return self.comm.all_gather(v, v.ndim - 1) if part else v

    def _local(self, v, level):
        """This rank's rows of a whole vector of ``level`` (or stack)."""
        if not self.plan[level]:
            return v
        lo, hi = self.rows[level]
        return v[..., lo:hi].contiguous()

    def _Ax(self, level, v):
        lv = self.levels[level]
        if lv.tier == "replicated":
            return spmv(lv.whole, v)
        if lv.tier == "gathered":
            # the block's rows against the whole vector, a member at a time
            full = self._full(v, True)
            if v.ndim == 1:
                return torch.sum(lv.data * full[lv.cols], dim=0)
            return torch.stack([torch.sum(lv.data * f[lv.cols], dim=0) for f in full])
        stack = v.ndim == 2
        if lv.halo:
            lo, hi = self.comm.exchange([(v, lv.halo, lv.halo)], int(stack))[0]
        else:
            lo = hi = v[..., :0]
        run = ell.spmv_banded_halo_batch if stack else ell.spmv_banded_halo
        return run(lv.data, lv.offsets, v, lo, hi)

    def _coarse(self, b):
        """The coarsest level's product with the dense inverse, one a
        member for a stack."""
        if b.ndim == 2:
            return torch.stack([matvec_full(self.coarse_inv, bm) for bm in b])
        return matvec_full(self.coarse_inv, b)

    def _smooth(self, level, b, x, iterations):
        """The single-device smoother (``core.algebraic._smooth_sparse``) on
        this rank's rows, each ``Ax`` the level's distributed product."""
        if iterations <= 0:
            return x
        cfg, lv = self.config, self.levels[level]
        if cfg.smoother == "chebyshev":
            lam = lv.lam_max
            r = b - self._Ax(level, x)
            d = (4.0 / 3.0) / lam * lv.inv_diag * r
            for k in range(1, iterations + 1):
                x = x + d
                if k == iterations:
                    break
                r = r - self._Ax(level, d)
                d = ((2 * k - 1) / (2 * k + 3)) * d + (
                    (8 * k + 4) / (2 * k + 3)
                ) / lam * lv.inv_diag * r
            return x
        if lv.colors is None:  # Jacobi (and GS without colours)
            for _ in range(iterations):
                x = x + cfg.omega * lv.inv_diag * (b - self._Ax(level, x))
            return x
        for _ in range(iterations):
            for c in range(lv.sweeps):
                upd = x + lv.inv_diag * (b - self._Ax(level, x))
                x = torch.where(lv.colors == c, upd, x)
        return x

    def _restrict(self, level, r):
        """``R r`` from level to level + 1: gather, the single-device
        transfer, this rank's rows."""
        out = _restrict_level(self._xfer, level, self._full(r, self.plan[level]))
        return out if self._geoms[level] is None else self._local(out, level + 1)

    def _prolong(self, level, ec):
        """``P ec`` from level + 1 to level, likewise."""
        out = _prolong_level(self._xfer, level, self._full(ec, self.plan[level + 1]))
        return out if self._geoms[level] is None else self._local(out, level)

    # -- the cycle ---------------------------------------------------------

    def _vc(self, level, b, x, gamma):
        """One µ-cycle from ``level`` (``core.algebraic.sparse_v_cycle``)."""
        cfg = self.config
        if level == self.hierarchy.num_levels - 1:
            return self._coarse(b)
        x = self._smooth(level, b, x, cfg.pre_iterations)
        bc = self._restrict(level, b - self._Ax(level, x))
        ec = torch.zeros_like(bc)
        visits = 1 if level == self.hierarchy.num_levels - 2 else gamma
        for _ in range(visits):
            ec = self._vc(level + 1, bc, ec, gamma)
        x = x + self._prolong(level, ec)
        return self._smooth(level, b, x, cfg.post_iterations)

    def _fmg(self, r):
        """``core.algebraic.sparse_fmg_cycle``: the rhs restricted to every
        level, the coarsest solved, then a V-cycle a level upward."""
        L = self.hierarchy.num_levels
        bs = [r]
        for level in range(L - 1):
            bs.append(self._restrict(level, bs[-1]))
        x = self._coarse(bs[-1])
        for level in range(L - 2, -1, -1):
            x = self._prolong(level, x)
            x = self._vc(level, bs[level], x, 1)
        return x

    def _cycle(self, r):
        if self.config.cycle_type == "f":
            return self._fmg(r)
        return self._vc(0, r, torch.zeros_like(r), self.gamma)

    def _pdot(self, a, b):
        """``a·b`` over the ranks; on a stack each member's, ``(K, 1)``."""
        if a.ndim == 1:
            s = torch.sum(a * b)
            return self.comm.all_reduce(s) if self.plan[0] else s
        s = _sums(a * b)
        s = self.comm.all_reduce(s, members=True) if self.plan[0] else s
        return s.reshape(-1, 1)

    def _pcg(self, r0):
        """``krylov_iters`` MG-preconditioned CG steps on ``A e = r0`` from
        zero (``core.algebraic._sparse_pcg``), the inner products summed
        over the ranks."""
        iters = self.config.krylov_iters
        e = torch.zeros_like(r0)
        r = r0
        z = self._cycle(r)
        p = z
        rz = self._pdot(r, z)
        for it in range(iters):
            Ap = self._Ax(0, p)
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
        """Double-float ``r = b − A x`` on this rank's rows (the terms of
        ``ops.sparse.spmv_df`` in slot order, then ``df_sub``) and its local
        ``Σ r_hi²`` (each member's on a stack ``(K, m)``, whose rows are its
        last axis).  Banded: one batch of ``(x_hi, x_lo)`` H-row slabs;
        irregular: the gathered pair."""
        xh, xl = x_pair
        stack = xh.ndim == 2
        if not self.plan[0]:
            ax = spmv_df(self.fine_hi, self.fine_lo, xh, xl)
        elif self.fine_offsets:
            H, m = self.fine_halo, xh.shape[-1]
            if H:
                (lh, hh), (ll, hl) = self.comm.exchange([(xh, H, H), (xl, H, H)],
                                                        int(stack))
                xh = torch.cat([lh, xh, hh], dim=-1)
                xl = torch.cat([ll, xl, hl], dim=-1)
            ax = None
            for j, d in enumerate(self.fine_offsets):
                xs = (xh[..., H + d: H + d + m], xl[..., H + d: H + d + m])
                term = df_mul((self.fine_hi[j], self.fine_lo[j]), xs)
                ax = term if ax is None else df_add(ax, term)
        else:
            xh, xl = self._full(xh, True), self._full(xl, True)
            ax = None
            for j in range(self.fine_hi.shape[0]):
                c = self.fine_cols[j]
                term = df_mul((self.fine_hi[j], self.fine_lo[j]), (xh[..., c], xl[..., c]))
                ax = term if ax is None else df_add(ax, term)
        r = df_sub(b_pair, ax)
        sq = r[0] * r[0]
        return r[0], _sums(sq) if stack else torch.sum(sq)

    def _inputs(self, b, x0):
        """One member's ``(b_pair, x_pair or None, native)`` on this rank's
        rows."""
        lo, hi = self.rows[0]
        native = isinstance(b, torch.Tensor) and b.dtype == torch.float32
        if native:
            if b.device != self.device:
                raise ValueError(f"b is on {b.device} but the solver is on {self.device}")
            bh = b.reshape(-1)[lo:hi].contiguous()
            b_pair = (bh, torch.zeros_like(bh))
        else:
            b_pair = df_split(np.ascontiguousarray(_host(b).reshape(-1)[lo:hi]), self.device)
        x_pair = None
        if x0 is not None:
            if native and isinstance(x0, torch.Tensor) and x0.dtype == torch.float32:
                xh = x0.reshape(-1)[lo:hi].to(self.device).contiguous()
                x_pair = (xh, torch.zeros_like(xh))
            else:
                x_pair = df_split(
                    np.ascontiguousarray(_host(x0).reshape(-1)[lo:hi]), self.device)
        return b_pair, x_pair, native

    def _info(self, solve_time):
        h = self.hierarchy
        return {
            "gridlevels": h.num_levels,
            "level_stats": self.stats,
            "format": h.fmt,
            "residual_mode": "doublefloat",
            "num_colors": self.num_colors,
            "outer_loop": "host",
            "solve_time_s": solve_time,
            "n_devices": self.n_dev,
            "partition_plan": self.plan,
            "band_halos": self.halos_per_level,
            "transport": self.comm.transport,
        }

    def solve(self, b, x0=None):
        """Solve ``A x = b``; ``b`` (and ``x0``) are the whole vector on
        every rank.  Same contract as ``AlgebraicSolver.solve``: a float32
        tensor ``b`` on the solver's device returns the float32 hi part on
        the device (the pair in ``info['x_df']``), anything else the exact
        float64 merge as numpy."""
        cfg = self.config
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        t_start = time.perf_counter()
        step, native = self._step(b, x0)
        (history,), (converged,), (cycle_times,), reads = lockstep(
            [step], limit, float(cfg.threshold), self._say, None, self._norms,
        )
        solve_time = time.perf_counter() - t_start
        k = len(history) - 1
        info = {
            "residual_norms": history,
            "cycles": k,
            "converged": bool(converged),
            "final_norm": history[-1],
            **self._info(solve_time),
            "cycle_times_s": cycle_times,
            "mean_cycle_time_s": solve_time / max(k, 1),
            "host_reads": reads,
        }
        return self._deliver(step.x, native, info), info

def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def hierarchy_settings(config: SolverConfig) -> dict:
    """The arguments :func:`setup_sparse_distributed` gives
    ``build_sparse_hierarchy`` besides the matrix and the shape: two
    configs with equal settings build the same hierarchy."""
    return dict(
        gridlevels=config.gridlevels,
        fmt="ell",
        transfer_name=config.transfer,
        dtype=np.dtype(config.dtype),
        residual_dtype="doublefloat",
        max_dense_coarse=config.max_dense_coarse,
        smoother=config.smoother,
    )


def setup_sparse_distributed(
    A,
    shape,
    config: SolverConfig | None = None,
    mesh_config: MeshConfig | None = None,
    *,
    device=None,
) -> DistributedAlgebraicSolver:
    """Build a :class:`DistributedAlgebraicSolver` on this rank for a sparse
    SPD ``A`` over the grid ``shape`` (the distributed twin of
    :func:`~openmg_tpu_torch.core.algebraic.setup_sparse`).

    The hierarchy is built on the host (scipy Galerkin chain), as the JAX
    package builds it, and this rank's share is copied to ``device``:
    ``cuda:{LOCAL_RANK}`` when None (never the CPU by itself); ``"cpu"``
    for CPU ranks, or ``"cuda:0"`` for ranks that share one card.  Joins
    the process group first if this process has not."""
    from openmg_tpu_torch.core.algebraic import build_sparse_hierarchy

    device = rank_device(device)
    if not dist.is_initialized():
        initialize_distributed(device=device)
    config = config or SolverConfig()
    hierarchy = build_sparse_hierarchy(A, shape, **hierarchy_settings(config), device="cpu")
    return DistributedAlgebraicSolver(hierarchy, config, mesh_config, device)
