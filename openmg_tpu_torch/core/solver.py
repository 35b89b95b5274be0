"""Public API (twin of ``openmg_tpu/core/solver.py``).

Two entry points:

* :func:`mg_solve` — ``mg_solve(A, b, parameters)`` with the original
  parameters-dict vocabulary: ``A=None`` assembles Poisson from
  ``problemshape``; a scipy/dense matrix is taken in its exact stencil form,
  or goes through the general sparse engine.
* :func:`setup` / :func:`solve` — build a :class:`Solver` once (hierarchy)
  from a grid shape (Poisson) or an ``(offsets, coeffs)`` stencil pair, then
  solve many right-hand sides.

Convergence loop (defect-correction form): because every cycle component
is linear, ``V(b, x) == x + V(b − A x, 0)``, so the solver iterates
``x ← x + V(r, 0)`` with the residual ``r = b − A x`` evaluated in
**double-float** (two-f32 compensated arithmetic,
:mod:`openmg_tpu_torch.ops.doublefloat`) while the V-cycle itself runs in
f32.  This is classical iterative refinement and is how an f32 cycle
reaches a 1e-10 absolute tolerance; in this mode no float64 touches the
device.

The outer loop is a Python loop (:func:`lockstep`) with one scalar read of
‖r‖ per cycle.
For a constant fine operator with dyadic taps a cycle is one V-cycle and
one launch of the double-float update/residual kernel (a 2D grid lifted to
``(1, ny, nx)``).  Any other fine operator (varying coefficients,
non-dyadic taps) takes the general double-float residual with Dekker
products, in tensor code as it is array code in the JAX package.
``residual_dtype="float32"`` / ``"float64"``
evaluate the residual in that plain type instead (float32 through the
per-pass stencil kernel, float64 as ``b − apply(A, x)``).

**Device rule.**  ``setup``, ``solve`` and ``mg_solve`` run on
``torch.device("cuda")`` when ``device`` is None and raise when there is no
CUDA device.  The CPU is used only when the caller passes ``device="cpu"``.

A matrix that is not stencil-representable, and an explicit
``format`` of ``ell``/``csr``/``bsr``/``dense``, go through the general
sparse engine (:mod:`openmg_tpu_torch.core.algebraic`).

The inner error solve of an outer step is one cycle of ``cycle_type``
(V, W or FMG) or, with ``krylov="pcg"``, ``krylov_iters`` MG-preconditioned
CG steps (:func:`_inner_solve`).  :meth:`Solver.solve_many` runs a batch of
right-hand sides in lockstep, one host read of the batch's norms a step.
The batch is one ``(K, *grid)`` stack (:class:`_Batch`) in every residual
mode: a step is one inner solve of the whole stack (each kernel in its
batched form: K1b or K5b a constant visit, K4b a varying leg, K3b or K4b a
composed pass) and one batched update and residual (K2b where the fine
operator takes the double-float kernel; the general double-float residual
and the float64 one in tensor code on the stack; the float32 one one K3b or
K4b launch), as the JAX package's vmapped program launches its kernels
once for all members.

Grids of one, two and three dimensions take the same loop; a 1D grid runs
through the kernels on its lift to ``(1, 1, n)``, as a 2D one does on
``(1, ny, nx)``.  ``dtype="float64"`` runs the whole cycle in float64 on
the CPU (``residual_dtype="auto"`` is then float64 too); on the card a
float64 cycle is refused, because the stencil kernels are float32.

Checkpoint/resume (:mod:`openmg_tpu_torch.utils.checkpoint`): with
``checkpoint_path`` the loop writes the full-precision iterate, the cycle
counter and the residual history every ``checkpoint_every`` cycles (one
host read a write); ``resume=True`` continues from the file.  The file
format and the configuration hash are the JAX package's, so a checkpoint
of either package resumes in the other.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from openmg_tpu_torch.core.config import ProblemConfig, SolverConfig
from openmg_tpu_torch.core.cycle import pcg_solve, run_cycle
from openmg_tpu_torch.core.hierarchy import (
    Hierarchy,
    build_hierarchy,
    build_hierarchy_structured,
)
from openmg_tpu_torch.models.poisson import poisson_offsets, stencil_from_csr
from openmg_tpu_torch.ops import kernels
from openmg_tpu_torch.ops.doublefloat import (
    df_add_f32,
    df_merge,
    df_mul,
    df_split,
    df_sub,
    pow2_terms,
)
from openmg_tpu_torch.ops.stencil import apply as stencil_apply
from openmg_tpu_torch.ops.stencil import residual as stencil_residual
from openmg_tpu_torch.ops.stencil import shift
from openmg_tpu_torch.ops.transfer import TRANSFERS

__all__ = ["Solver", "setup", "solve", "mg_solve", "exact_residual_terms"]


def _resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Never falls back to the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: openmg_tpu_torch runs on the GPU by "
                "default; pass device='cpu' explicitly to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is there")
    return device


def _resolve_residual_mode(name, cycle_dtype=torch.float32):
    """``"doublefloat"``, a torch dtype, or None (the cycle's dtype).
    ``"auto"`` means double-float on every device for a float32 cycle, and
    float64 for a float64 cycle (the JAX package's ``"auto"`` on the CPU with
    x64 on)."""
    if name in (None, ""):
        return None
    if name == "auto" and cycle_dtype == torch.float64:
        return torch.float64
    if name in ("doublefloat", "auto"):
        return "doublefloat"
    if name in ("float32", "float64"):
        return getattr(torch, name)
    raise ValueError(
        f"residual_dtype={name!r}; choose doublefloat|auto|float32|float64"
    )


def _cycle_dtype(name, device) -> torch.dtype:
    """The cycle's torch dtype for ``SolverConfig.dtype``: float32 on any
    device, float64 on the CPU only (the stencil kernels are float32, and
    plain tensor code does not run on the card)."""
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype={name!r}; choose float32|float64")
    if name == "float64" and torch.device(device).type != "cpu":
        raise NotImplementedError(
            f"a float64 cycle on {device}: the stencil kernels take float32 "
            "only, and plain tensor code does not run on the card"
        )
    return getattr(torch, name)


def exact_residual_terms(hierarchy: Hierarchy):
    """Static per-tap power-of-two decompositions of the fine operator, or
    None when the exact residual does not apply (varying coefficients, a
    nonzero double-float lo part, or non-dyadic taps).  Reads the (K,)
    value vectors once, at solver construction."""
    fh, fl = hierarchy.fine_hi, hierarchy.fine_hi_lo
    if fl is None or not fh.is_constant or not fl.is_constant:
        return None
    if np.any(fl.values.cpu().numpy()):
        return None
    terms = tuple(pow2_terms(float(v)) for v in fh.values.cpu().numpy())
    if any(t is None for t in terms):
        return None
    return terms


def _norm(t):
    """‖t‖₂, a 0-d tensor on ``t``'s device."""
    return torch.sqrt(torch.sum(t * t))


def _norms(t):
    """Each member's ‖t_m‖₂ of a batch ``(K, ...)``, a ``(K,)`` tensor:
    every member's sum by the scalar :func:`_norm`'s call on its rows (one
    reduction over the batch need not add in that order)."""
    return torch.sqrt(torch.stack([torch.sum(row) for row in t * t]))


def _residual_norm_df_exact(offsets, terms, b_df, x_df, norm=_norm):
    """Double-float residual ``b − A x`` for a constant operator with dyadic
    taps, and ‖r_hi‖₂, in plain tensor code (it runs once per solve, for a
    caller's nonzero ``x0``; the per-cycle residual is the kernel's).  On a
    batch pass ``norm=_norms``."""
    acc = b_df
    for off, tp in zip(offsets, terms):
        xh = shift(x_df[0], off)
        xl = shift(x_df[1], off)
        for p in tp:
            acc = df_sub(acc, (float(p) * xh, float(p) * xl))
    return acc, norm(acc[0])


def _residual_norm_df(A_hi, A_lo, b_df, x_df, norm=_norm):
    """Double-float residual ``r = b − A x`` with compensated accumulation
    and Dekker products, all float32 tensor code.  Works for varying and
    constant operators (0-d coefficients broadcast), and on a batch
    (``norm=_norms``)."""
    acc = b_df
    for k, off in enumerate(A_hi.offsets):
        xs = (shift(x_df[0], off), shift(x_df[1], off))
        term = df_mul((A_hi.coeff(k), A_lo.coeff(k)), xs)
        acc = df_sub(acc, term)
    return acc, norm(acc[0])


def _residual_norm(fine_hi, b, x, norm=_norm):
    """Residual and its norm in the plain residual dtype.  float32 goes
    through :func:`openmg_tpu_torch.ops.stencil.residual` (on the card: one
    launch of the per-pass kernel, K3b/K4b on a batch); float64 is ``b −
    apply(A, x)`` in tensor code on any device and never reaches a float32
    kernel."""
    if x.dtype == torch.float32:
        r = stencil_residual(fine_hi, b, x)
    else:
        r = b - stencil_apply(fine_hi, x)
    return r, norm(r)


def _inner_solve(
    h, r, *, cycle_type, pre, post, smoother, omega, krylov, krylov_iters
):
    """Inner error solver of the defect-correction loop: one MG cycle or
    ``krylov_iters`` MG-preconditioned CG steps."""
    if krylov == "pcg":
        return pcg_solve(
            h, r, krylov_iters, cycle_type, pre, post, smoother, omega
        )
    if krylov not in (None, "none"):
        raise ValueError(f"unknown krylov {krylov!r}; choose none|pcg")
    return run_cycle(h, r, cycle_type, pre, post, smoother, omega)


class _DFExactStep:
    """The outer loop's state for one right-hand side when the fine operator
    is constant with dyadic taps: a step is one inner solve and one launch
    of the double-float update/residual kernel (K2)."""

    def __init__(self, offsets, terms, b_df, x, inner):
        self.offsets, self.terms, self.b_df, self.inner = offsets, terms, b_df, inner
        b_hi = b_df[0]
        if x is None:
            # the residual of the zero iterate is b itself
            self.x = (torch.zeros_like(b_hi), torch.zeros_like(b_hi))
            self.r = b_hi
            self.rn = torch.sqrt(torch.sum(b_hi * b_hi))
        else:
            self.x = x
            r_pair, self.rn = _residual_norm_df_exact(offsets, terms, b_df, x)
            self.r = r_pair[0]

    def advance(self):
        e = self.inner(self.r)
        x_hi, x_lo, self.r, pn = kernels.df_update_residual_const_3d(
            self.offsets, self.terms, self.x[0], self.x[1], e, self.b_df[0],
            self.b_df[1], emit_norm=True,
        )
        self.x = (x_hi, x_lo)
        self.rn = torch.sqrt(torch.sum(pn))


class _Batch:
    """The outer loops of a batch of right-hand sides as one ``(n, *grid)``
    stack of the members still running (``members``, in order), in any
    residual mode.  The iterate ``x`` and the right-hand side ``b`` are
    tuples of stacks (a double-float pair, or one array); a step is one
    inner solve of the stack and ``step(x, b, e) -> (x, r, rn)``, the
    mode's batched update and residual, ``rn`` the ``(n,)`` norms.  A member
    that stops is taken out of the stack (:meth:`narrow`) with its iterate
    frozen; the stack is rebuilt from views of the old one, on the card,
    with no host copy.  Every member's arithmetic is its scalar step's."""

    def __init__(self, x, b, r, rn, step, inner):
        self.x, self.b, self.r, self.rn = x, b, r, rn
        self.step, self.inner = step, inner
        K = r.shape[0]
        self.members = list(range(K))
        self.frozen = [None] * K

    @classmethod
    def general(cls, x, b, resid, update, inner):
        """A batch whose step is ``update(x, e)`` then ``resid(x, b) -> (r,
        rn)``, started from ``resid`` of ``x``."""
        def step(xx, bb, e):
            xx = update(xx, e)
            return (xx, *resid(xx, bb))

        return cls(x, b, *resid(x, b), step, inner)

    def norms(self, pending):
        """The norms of ``pending`` (the members in the stack) in one
        device-to-host copy."""
        if pending != self.members:
            raise RuntimeError(f"members {pending} read, {self.members} in the batch")
        return self.rn.cpu().tolist()

    def narrow(self, keep):
        """Keep the members ``keep`` (a subsequence of ``members``) in the
        stack; the others are frozen with their iterates as they stand."""
        if keep == self.members:
            return
        pos = {m: p for p, m in enumerate(self.members)}
        for m in self.members:
            if m not in keep:
                self.frozen[m] = tuple(t[pos[m]] for t in self.x)
        rows = [pos[m] for m in keep]

        def pick(t):
            return torch.stack([t[p] for p in rows])

        self.x = tuple(pick(t) for t in self.x)
        self.b = tuple(pick(t) for t in self.b)
        self.r, self.rn = pick(self.r), pick(self.rn)
        self.members = list(keep)

    def advance(self, keep):
        """One outer step of the members ``keep``."""
        self.narrow(keep)
        self.x, self.r, self.rn = self.step(self.x, self.b, self.inner(self.r))

    def iterates(self):
        """Every member's iterate as it stands, stacked in member order: a
        tuple like ``x``."""
        pos = {m: p for p, m in enumerate(self.members)}
        got = [
            self.frozen[m] if m not in pos else tuple(t[pos[m]] for t in self.x)
            for m in range(len(self.frozen))
        ]
        return tuple(torch.stack([g[j] for g in got]) for j in range(len(self.x)))


class _Step:
    """The outer loop's state for one right-hand side, in general:
    ``resid(x) -> (r, ‖r‖)`` after every update ``update(x, inner(r))``."""

    def __init__(self, x, resid, update, inner):
        self.x, self.resid, self.update, self.inner = x, resid, update, inner
        self.r, self.rn = resid(x)

    def advance(self):
        self.x = self.update(self.x, self.inner(self.r))
        self.r, self.rn = self.resid(self.x)


def lockstep(steps, limit, threshold, say=None, after=None, norms=None,
             advance=None):
    """Run the outer loops of ``steps`` (each with a 0-d tensor ``rn``, its
    residual norm, and ``advance()``) in lockstep.  Every round reads the
    norms of the members not yet done to the host in ONE copy; a member
    below ``threshold`` is done and frozen (never advanced again), as is one
    that has taken ``limit`` steps; the others advance one step each, one
    after another, or with ``advance`` all in one call ``advance(nxt)``
    (a batch; ``norms(pending)`` then reads the pending members' norms,
    and ``steps`` only names the members).  A single
    member reads its one scalar.

    Returns ``(histories, converged, step_times, reads)``: per member the
    norms before each step and after the last, whether it converged, the
    host seconds of each of its steps (enqueue times), and the number of
    device-to-host reads made."""
    hist = [[] for _ in steps]
    times = [[] for _ in steps]
    converged = [False] * len(steps)
    pending = list(range(len(steps)))
    reads = 0
    while pending:
        if advance is not None:
            vals = norms(pending)
        elif norms is not None:
            vals = norms([steps[i].rn for i in pending])
        elif len(pending) == 1:
            vals = [float(steps[pending[0]].rn)]
        else:
            vals = torch.stack([steps[i].rn for i in pending]).cpu().tolist()
        reads += 1
        nxt = []
        for i, v in zip(pending, vals):
            hist[i].append(v)
            if say is not None:
                say(i, len(hist[i]) - 1, v)
            if v < threshold:
                converged[i] = True
            elif len(hist[i]) <= limit:
                nxt.append(i)
        if advance is not None and nxt:
            t0 = time.perf_counter()
            advance(nxt)
            dt = time.perf_counter() - t0
            for i in nxt:
                times[i].append(dt)
        for i in nxt:
            if advance is None:
                t0 = time.perf_counter()
                steps[i].advance()
                times[i].append(time.perf_counter() - t0)
            if after is not None:
                after(i, hist[i])
        pending = nxt
    return hist, converged, times, reads


class _Checkpointer:
    """The checkpoint side of an outer loop: what a resume starts from
    (``x0``, ``start`` cycles done, their ``history``) and the writes every
    ``every`` cycles (``save``).  Inert without a path."""

    def __init__(self, path, every, resume, config, grid_shape, write=True):
        import os

        from openmg_tpu_torch.utils.checkpoint import config_hash, load_checkpoint

        self.path, self.every, self.write = path, int(every), write
        self.x0, self.start, self.history, self.writes = None, 0, [], 0
        if path is None:
            return
        if self.every < 1:
            raise ValueError(f"checkpoint_every={every}; must be >= 1")
        self.hash = config_hash(config, grid_shape)
        if resume and os.path.exists(path):
            x0, self.start, self.history = load_checkpoint(path, self.hash)
            self.x0 = x0.reshape(tuple(grid_shape))

    def save(self, merged, hist):
        """After a step of the loop, whose norms so far are ``hist`` (one a
        step): write ``merged()`` (the iterate as float64 numpy, one host
        read) when the cycle count is a multiple of ``every``.  ``write``
        False (a distributed rank other than the first) gathers but does
        not write."""
        from openmg_tpu_torch.utils.checkpoint import save_checkpoint

        cycle = self.start + len(hist)
        if self.path is None or cycle % self.every:
            return
        x = merged()
        self.writes += 1
        if self.write:
            save_checkpoint(self.path, x, cycle, self.history + list(hist), self.hash)


class Solver:
    """A configured multigrid solver bound to one operator hierarchy."""

    def __init__(self, hierarchy: Hierarchy, config: SolverConfig):
        self.hierarchy = hierarchy
        self.config = config
        self.device = hierarchy.device
        self.dtype = _cycle_dtype(config.dtype, self.device)
        self.residual_mode = (
            _resolve_residual_mode(config.residual_dtype, self.dtype)
            or self.dtype
        )
        if len(hierarchy.grid_shape) not in (1, 2, 3):
            raise ValueError(
                f"a {len(hierarchy.grid_shape)}D grid: grids of 1, 2 or 3 "
                "dimensions are solved"
            )
        if self.residual_mode == "doublefloat" and hierarchy.fine_hi_lo is None:
            raise ValueError(
                "hierarchy was not built with residual_dtype='doublefloat'"
            )
        if self.residual_mode == "doublefloat" and self.dtype != torch.float32:
            raise ValueError(
                "the double-float residual pairs with a float32 cycle; a "
                "float64 cycle takes residual_dtype='float64' or 'auto'"
            )
        self._exact_terms = (
            exact_residual_terms(hierarchy)
            if self.residual_mode == "doublefloat"
            else None
        )

    @property
    def grid_shape(self):
        return self.hierarchy.grid_shape

    def _inner(self, r):
        cfg = self.config
        return _inner_solve(
            self.hierarchy, r.to(self.dtype), cycle_type=cfg.cycle_type,
            pre=cfg.pre_iterations, post=cfg.post_iterations,
            smoother=cfg.smoother, omega=cfg.omega, krylov=cfg.krylov,
            krylov_iters=cfg.krylov_iters,
        )

    def _inputs(self, b, x0):
        """``b`` and ``x0`` as the outer loop takes them: ``(b, b_np, x0_np,
        device_native)``, where ``device_native`` says that ``b`` is a
        float32 tensor on the solver's device (then ``b_np`` is None) and
        the others are float64 numpy grids (``x0_np`` None without x0)."""
        shape = self.grid_shape
        dev = self.device
        device_native = isinstance(b, torch.Tensor) and b.dtype == torch.float32
        if device_native:
            if b.device != dev:
                raise ValueError(
                    f"b is on {b.device} but the solver was set up on {dev}"
                )
            b_np = None
        else:
            if isinstance(b, torch.Tensor):
                b = b.detach().cpu().numpy()
            b_np = np.asarray(b, dtype=np.float64).reshape(shape)
        if isinstance(x0, torch.Tensor):
            x0 = x0.detach().cpu().numpy()
        x0_np = (
            None if x0 is None
            else np.asarray(x0, dtype=np.float64).reshape(shape)
        )
        return b, b_np, x0_np, device_native

    def _df_inputs(self, b, x0):
        """The double-float loop's ``(b_hi, b_lo)``, ``x`` (a pair, or None
        for a zero start) and whether ``b`` is device-native."""
        b, b_np, x0_np, device_native = self._inputs(b, x0)
        if device_native:
            b_hi = b.reshape(self.grid_shape).contiguous()
            b_lo = torch.zeros_like(b_hi)
        else:
            b_hi, b_lo = df_split(b_np, self.device)
        x = None if x0_np is None else df_split(x0_np, self.device)
        return (b_hi, b_lo), x, device_native

    def _step(self, b, x0):
        """The outer loop's state for ``A x = b`` from ``x0``, and whether
        ``b`` is device-native (a float32 tensor on the solver's device)."""
        h = self.hierarchy
        if self.residual_mode == "doublefloat":
            (b_hi, b_lo), x, device_native = self._df_inputs(b, x0)
            if self._exact_terms is not None:
                step = _DFExactStep(
                    h.fine_hi.offsets, self._exact_terms, (b_hi, b_lo), x,
                    self._inner,
                )
                return step, device_native
            if x is None:
                x = (torch.zeros_like(b_hi), torch.zeros_like(b_hi))

            def resid(xx):
                r_pair, rn = _residual_norm_df(
                    h.fine_hi, h.fine_hi_lo, (b_hi, b_lo), xx
                )
                return r_pair[0], rn  # the cycle takes the hi part

            return _Step(x, resid, df_add_f32, self._inner), device_native
        b_r, x, device_native = self._plain_inputs(b, x0)
        rd = self.residual_mode
        step = _Step(
            x, lambda xx: _residual_norm(h.fine_hi, b_r, xx),
            lambda xx, e: xx + e.to(rd), self._inner,
        )
        return step, device_native

    def _plain_inputs(self, b, x0):
        """The plain residual modes' ``b`` and ``x`` (zero without ``x0``)
        in the residual dtype on the solver's device, and whether ``b`` is
        device-native."""
        b, b_np, x0_np, device_native = self._inputs(b, x0)
        rd = self.residual_mode
        dev = self.device
        if device_native:
            b_r = b.reshape(self.grid_shape).to(rd).contiguous()
        else:
            b_r = torch.from_numpy(b_np).to(device=dev, dtype=rd)
        if x0_np is None:
            x = torch.zeros_like(b_r)
        else:
            x = torch.from_numpy(x0_np).to(device=dev, dtype=rd)
        return b_r, x, device_native

    def _batch(self, members, x0s):
        """The outer loops of ``members`` from ``x0s`` as one :class:`_Batch`
        in the solver's residual mode."""
        h = self.hierarchy
        K = len(members)
        if self.residual_mode != "doublefloat":
            ins = [self._plain_inputs(b, x0) for b, x0 in zip(members, x0s)]
            x = (torch.stack([i[1] for i in ins]),)
            b = (torch.stack([i[0] for i in ins]),)
            rd = self.residual_mode
            return _Batch.general(
                x, b, lambda xx, bb: _residual_norm(h.fine_hi, bb[0], xx[0], _norms),
                lambda xx, e: (xx[0] + e.to(rd),), self._inner,
            )
        ins = [self._df_inputs(b, x0) for b, x0 in zip(members, x0s)]
        b = tuple(torch.stack([i[0][j] for i in ins]) for j in (0, 1))
        zero = torch.zeros_like(b[0][0])
        x = tuple(
            torch.stack([zero if i[1] is None else i[1][j] for i in ins])
            for j in (0, 1)
        )
        if self._exact_terms is None:
            def resid(xx, bb):
                r_pair, rn = _residual_norm_df(h.fine_hi, h.fine_hi_lo, bb, xx,
                                               _norms)
                return r_pair[0], rn  # the cycle takes the hi part

            return _Batch.general(x, b, resid, df_add_f32, self._inner)
        offs, terms = h.fine_hi.offsets, self._exact_terms
        # the start, as each member's scalar step makes it: b itself from a
        # zero iterate, the exact residual in tensor code from an x0
        r, rn = b[0], _norms(b[0])
        given = [i[1] is not None for i in ins]
        if any(given):
            r_pair, rn_x = _residual_norm_df_exact(offs, terms, b, x, _norms)
            r = torch.stack([r_pair[0][m] if given[m] else r[m] for m in range(K)])
            rn = torch.stack([rn_x[m] if given[m] else rn[m] for m in range(K)])

        def step(xx, bb, e):
            x_hi, x_lo, r_hi, pn = kernels.df_update_residual_batch(
                offs, terms, xx[0], xx[1], e, bb[0], bb[1], emit_norm=True,
            )
            return (x_hi, x_lo), r_hi, kernels.df_norms(pn)

        return _Batch(x, b, r, rn, step, self._inner)

    def _info(self, solve_time):
        h = self.hierarchy
        mode = self.residual_mode
        return {
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "transfer": h.transfer.name,
            "residual_mode": (
                mode if mode == "doublefloat" else str(mode).replace("torch.", "")
            ),
            "outer_loop": "host",
            "solve_time_s": solve_time,
        }

    def solve(
        self,
        b,
        x0=None,
        *,
        checkpoint_path=None,
        checkpoint_every: int = 1,
        resume: bool = False,
    ):
        """Solve ``A x = b`` to the configured threshold.

        ``b`` is grid-shaped (or flat; it is reshaped).  Returns
        ``(x, info)`` with the per-cycle residual-norm history; a cycle is
        one outer step (one inner solve: a cycle, or ``krylov_iters`` CG
        steps with ``krylov="pcg"``).

        ``info["host_reads"]`` counts the loop's device-to-host reads (one
        before every outer step and one after the last; a checkpoint write
        adds its own).

        Checkpoint/resume: with ``checkpoint_path`` the full-precision
        iterate, the cycle counter and the residual history are written
        atomically every ``checkpoint_every`` cycles; ``resume=True``
        restarts from the file when it exists (the configuration hash is
        checked: a checkpoint resumes only into the same solver on the
        same problem).  A resumed solve takes the cycles the uncut one
        would have taken, and ``info["cycles"]`` counts them from the
        start.

        Result type follows the input (see :meth:`_deliver`): numpy/f64
        ``b`` → exact float64 numpy ``x``; a float32 tensor ``b`` on the
        solver's device → float32 tensor ``x`` on that device, with the
        full-precision pair in ``info['x_df']``.
        """
        cfg = self.config
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        t_start = time.perf_counter()
        ckpt = _Checkpointer(
            checkpoint_path, checkpoint_every, resume, cfg, self.grid_shape
        )
        if ckpt.x0 is not None:
            x0 = ckpt.x0
        step, device_native = self._step(b, x0)
        df = self.residual_mode == "doublefloat"

        def after(_, hist):
            ckpt.save(lambda: df_merge(step.x) if df else
                      step.x.detach().cpu().numpy().astype(np.float64), hist)

        (history,), (converged,), _, reads = lockstep(
            [step], limit - ckpt.start, float(cfg.threshold), self._say,
            after if checkpoint_path is not None else None,
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
        return self._deliver(step.x, df, device_native, info), info

    def solve_many(self, bs, x0s=None):
        """Solve ``A x = b`` for a batch of right-hand sides in lockstep.

        ``bs``: ``(K, *grid)`` (or a sequence of grid arrays); ``x0s``
        likewise, or None.  Every round advances each member that has not
        converged by one outer step and reads the K norms to the host in
        one copy; a converged member is frozen.  The members run as one
        stack (:class:`_Batch`) in every residual mode: each kernel of a
        step is one launch of its batched form for the whole stack, and
        each member is bit-equal to its scalar :meth:`solve`.

        Returns ``(xs, info)``: ``xs`` stacked like :meth:`solve` returns
        (a float32 tensor batch on the solver's device gives the float32
        hi parts, the pairs in ``info['x_df']``; other input stacked
        float64 numpy); ``info`` carries per-member ``cycles``,
        ``converged``, ``final_norm`` and ``residual_norms``, ``batch``, and
        ``host_reads`` (device-to-host reads of the loop).
        """
        cfg = self.config
        shape = self.grid_shape
        device_native = isinstance(bs, torch.Tensor) and bs.dtype == torch.float32
        if device_native:
            members = list(bs.reshape((bs.shape[0],) + tuple(shape)))
        else:
            members = list(bs)  # each converted as solve converts it
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
        xs = batch.iterates()
        if self.residual_mode != "doublefloat":
            if device_native:
                return xs[0], info
            return xs[0].detach().cpu().numpy().astype(np.float64), info
        if device_native:
            info["x_df"] = xs
            return xs[0], info
        return df_merge(xs), info

    def _say(self, i, k, rnorm, batch=False):
        if self.config.verbose:
            who = f" rhs {i}" if batch else ""
            print(f"[openmg_tpu_torch]{who} cycle {k}: ‖r‖ = {rnorm:.3e}")

    @staticmethod
    def _deliver(x, df, device_native, info):
        """Result delivery policy: a host caller (numpy/f64 input) gets the
        exact float64 merge of the pair on the host; a device-native caller
        (f32 tensor input) gets the f32 solution as a tensor on the device,
        with the full-precision ``(hi, lo)`` pair in ``info['x_df']`` —
        never a device→host→device round trip.  The plain residual modes
        deliver their one array the same way."""
        if not df:
            if device_native:
                return x
            return x.detach().cpu().numpy().astype(np.float64)
        if device_native:
            info["x_df"] = x
            return x[0]
        return df_merge(x)


def setup(
    problem, config: SolverConfig | None = None, *, faced: bool = True,
    device=None,
) -> Solver:
    """Build a :class:`Solver` on ``device`` (CUDA when None; see the
    module's device rule).

    ``problem`` is a :class:`ProblemConfig`, a grid shape tuple (Poisson is
    assembled), or an ``(offsets, coeffs)`` stencil pair with numpy
    coefficient grids.  ``faced`` is passed on to
    :func:`build_hierarchy_structured`: with ``False`` a grid shape's
    levels that are not constant are stored as coefficient grids.
    """
    device = _resolve_device(device)
    config = config or SolverConfig()
    if config.transfer not in TRANSFERS:
        raise ValueError(
            f"unknown transfer {config.transfer!r}; choose from {sorted(TRANSFERS)}"
        )
    dtype = _cycle_dtype(config.dtype, device)
    rmode = _resolve_residual_mode(config.residual_dtype, dtype) or dtype
    if isinstance(problem, ProblemConfig):
        shape_like = tuple(problem.shape)
    elif isinstance(problem, (tuple, list)) and all(
        isinstance(s, (int, np.integer)) for s in problem
    ):
        shape_like = tuple(int(s) for s in problem)
    else:
        shape_like = None
    common = dict(
        gridlevels=config.gridlevels,
        dtype=dtype,
        residual_dtype=rmode,
        transfer=TRANSFERS[config.transfer],
        max_dense_coarse=config.max_dense_coarse,
        min_coarse_dim=config.min_coarse_dim,
        device=device,
    )
    if shape_like is not None:
        d = len(shape_like)
        hierarchy = build_hierarchy_structured(
            poisson_offsets(d), [2.0 * d] + [-1.0] * (2 * d), shape_like,
            faced=faced, **common
        )
    elif isinstance(problem, tuple) and len(problem) == 2:
        offsets, coeffs = problem
        hierarchy = build_hierarchy(
            offsets, coeffs, setup_dtype=config.setup_dtype, **common
        )
    else:
        raise TypeError(f"unsupported problem spec: {type(problem)}")
    return Solver(hierarchy, config)


def solve(problem, b, config: SolverConfig | None = None, x0=None, *, device=None):
    """One-shot native API: setup + solve."""
    return setup(problem, config, device=device).solve(b, x0)


def mg_solve(A, b, parameters: dict, *, device=None):
    """Parameters-dict entry point.  ``A`` is a scipy sparse or dense matrix
    over the grid named by ``parameters['problemshape']``, or None to
    assemble the Poisson operator; ``b`` is flat or grid-shaped.  Returns
    ``(x, info)`` with ``x`` a flat numpy vector.

    Engine choice (``parameters["format"]``), as in the JAX package: with
    ``"auto"`` or ``"stencil"`` a matrix is taken in its exact stencil form
    (:func:`~openmg_tpu_torch.models.poisson.stencil_from_csr`) and goes
    through the stencil engine (``A=None`` uses
    ``build_hierarchy_structured``, which yields exactly the operators of the
    direct Galerkin chain); ``"ell"``, ``"csr"``, ``"bsr"`` or ``"dense"``,
    and under ``"auto"`` a matrix that is not stencil-representable, go
    through the general sparse engine
    (:func:`~openmg_tpu_torch.core.algebraic.setup_sparse`).
    """
    if "problemshape" not in parameters:
        raise ValueError("parameters must include 'problemshape'")
    shape = tuple(int(s) for s in parameters["problemshape"])
    config = SolverConfig.from_parameters(parameters)
    fmt = config.format
    if A is None and fmt in ("auto", "stencil"):
        solver = setup(shape, config, device=device)
    elif fmt in ("ell", "csr", "bsr", "dense"):
        from openmg_tpu_torch.core.algebraic import setup_sparse
        from openmg_tpu_torch.models.poisson import poisson

        A_in = poisson(shape) if A is None else A
        solver = setup_sparse(A_in, shape, config, device=device)
    else:
        import scipy.sparse as sp

        A_sp = sp.csr_matrix(A)
        try:
            stencil = stencil_from_csr(A_sp, shape)
        except ValueError:
            if fmt == "stencil":
                raise
            from openmg_tpu_torch.core.algebraic import setup_sparse

            solver = setup_sparse(A_sp, shape, config, device=device)
        else:
            solver = setup(stencil, config, device=device)
    x, info = solver.solve(b)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1), info
