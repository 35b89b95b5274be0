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

The outer loop is a Python loop with one scalar read of ‖r‖ per cycle.
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

Waiting for later slices (each raises ``NotImplementedError``):
``Solver.solve_many``, checkpoint/resume, ``krylov="pcg"``, W/FMG cycles,
the chebyshev smoother and 1D grids on the stencil engine.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from openmg_tpu_torch.core.config import ProblemConfig, SolverConfig
from openmg_tpu_torch.core.cycle import run_cycle
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


def _resolve_residual_mode(name):
    """``"doublefloat"``, a torch dtype, or None (the cycle's dtype).
    ``"auto"`` means double-float on every device."""
    if name in (None, ""):
        return None
    if name in ("doublefloat", "auto"):
        return "doublefloat"
    if name in ("float32", "float64"):
        return getattr(torch, name)
    raise ValueError(
        f"residual_dtype={name!r}; choose doublefloat|auto|float32|float64"
    )


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


def _residual_norm_df_exact(offsets, terms, b_df, x_df):
    """Double-float residual ``b − A x`` for a constant operator with dyadic
    taps, and ‖r_hi‖₂, in plain tensor code (it runs once per solve, for a
    caller's nonzero ``x0``; the per-cycle residual is the kernel's)."""
    acc = b_df
    for off, tp in zip(offsets, terms):
        xh = shift(x_df[0], off)
        xl = shift(x_df[1], off)
        for p in tp:
            acc = df_sub(acc, (float(p) * xh, float(p) * xl))
    rn = torch.sqrt(torch.sum(acc[0] * acc[0]))
    return acc, rn


def _residual_norm_df(A_hi, A_lo, b_df, x_df):
    """Double-float residual ``r = b − A x`` with compensated accumulation
    and Dekker products, all float32 tensor code.  Works for varying and
    constant operators (0-d coefficients broadcast)."""
    acc = b_df
    for k, off in enumerate(A_hi.offsets):
        xs = (shift(x_df[0], off), shift(x_df[1], off))
        term = df_mul((A_hi.coeff(k), A_lo.coeff(k)), xs)
        acc = df_sub(acc, term)
    rn = torch.sqrt(torch.sum(acc[0] * acc[0]))
    return acc, rn


def _residual_norm(fine_hi, b, x):
    """Residual and its norm in the plain residual dtype.  float32 goes
    through :func:`openmg_tpu_torch.ops.stencil.residual` (on the card: one
    launch of the per-pass kernel); float64 is ``b − apply(A, x)`` in tensor
    code on any device and never reaches a float32 kernel."""
    if x.dtype == torch.float32:
        r = stencil_residual(fine_hi, b, x)
    else:
        r = b - stencil_apply(fine_hi, x)
    return r, torch.sqrt(torch.sum(r * r))


class Solver:
    """A configured multigrid solver bound to one operator hierarchy."""

    def __init__(self, hierarchy: Hierarchy, config: SolverConfig):
        self.hierarchy = hierarchy
        self.config = config
        self.device = hierarchy.device
        if config.dtype != "float32":
            raise NotImplementedError(
                f"dtype={config.dtype!r}: the cycle is ported for float32 only"
            )
        self.residual_mode = (
            _resolve_residual_mode(config.residual_dtype) or torch.float32
        )
        if len(hierarchy.grid_shape) not in (2, 3):
            raise NotImplementedError(
                f"a {len(hierarchy.grid_shape)}D grid: the cycle is ported for "
                "2D and 3D grids; 1D grids are not ported yet (ROADMAP queue 1, "
                "item 17)"
            )
        if self.residual_mode == "doublefloat" and hierarchy.fine_hi_lo is None:
            raise ValueError(
                "hierarchy was not built with residual_dtype='doublefloat'"
            )
        if config.krylov not in (None, "none"):
            raise NotImplementedError(
                f"krylov={config.krylov!r} is not ported yet (ROADMAP queue 1, "
                "item 14)"
            )
        if config.cycle_type != "v":
            raise NotImplementedError(
                f"cycle_type={config.cycle_type!r} is not ported yet (ROADMAP "
                "queue 1, item 14)"
            )
        if config.smoother == "chebyshev":
            raise NotImplementedError(
                "the chebyshev smoother is not ported yet (ROADMAP queue 1, "
                "item 15)"
            )
        self._exact_terms = (
            exact_residual_terms(hierarchy)
            if self.residual_mode == "doublefloat"
            else None
        )

    @property
    def grid_shape(self):
        return self.hierarchy.grid_shape

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
        ``(x, info)`` with the per-cycle residual-norm history.

        Result type follows the input (see :meth:`_deliver`): numpy/f64
        ``b`` → exact float64 numpy ``x``; a float32 tensor ``b`` on the
        solver's device → float32 tensor ``x`` on that device, with the
        full-precision pair in ``info['x_df']``.
        """
        if checkpoint_path is not None or resume:
            raise NotImplementedError(
                "checkpoint/resume is not ported yet (ROADMAP queue 1, item 19)"
            )
        cfg = self.config
        h = self.hierarchy
        shape = self.grid_shape
        dev = self.device
        df = self.residual_mode == "doublefloat"

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
        limit = cfg.cycles if cfg.cycles > 0 else 10_000
        threshold = float(cfg.threshold)

        def cycle(r):
            return run_cycle(
                h, r, cfg.cycle_type, cfg.pre_iterations, cfg.post_iterations,
                cfg.smoother, cfg.omega,
            )

        t_start = time.perf_counter()
        if df:
            if device_native:
                b_hi = b.reshape(shape).contiguous()
                b_lo = torch.zeros_like(b_hi)
            else:
                b_hi, b_lo = df_split(b_np, dev)
            x = None if x0_np is None else df_split(x0_np, dev)
            if self._exact_terms is not None:
                x, history, converged = self._loop_df_exact(
                    (b_hi, b_lo), x, cycle, limit, threshold
                )
            else:
                if x is None:
                    x = (torch.zeros_like(b_hi), torch.zeros_like(b_hi))

                def resid(xx):
                    r_pair, rn = _residual_norm_df(
                        h.fine_hi, h.fine_hi_lo, (b_hi, b_lo), xx
                    )
                    return r_pair[0], rn  # the cycle takes the hi part

                x, history, converged = self._loop(
                    resid, df_add_f32, x, cycle, limit, threshold
                )
        else:
            rd = self.residual_mode
            if device_native:
                b_r = b.reshape(shape).to(rd).contiguous()
            else:
                b_r = torch.from_numpy(b_np).to(device=dev, dtype=rd)
            if x0_np is None:
                x = torch.zeros_like(b_r)
            else:
                x = torch.from_numpy(x0_np).to(device=dev, dtype=rd)
            x, history, converged = self._loop(
                lambda xx: _residual_norm(h.fine_hi, b_r, xx),
                lambda xx, e: xx + e.to(rd), x, cycle, limit, threshold,
            )
        solve_time = time.perf_counter() - t_start
        k = len(history) - 1

        info = {
            "residual_norms": history,
            "cycles": k,
            "converged": bool(converged),
            "final_norm": history[-1],
            "gridlevels": h.num_levels,
            "level_stats": h.stats,
            "transfer": h.transfer.name,
            "residual_mode": (
                "doublefloat" if df else str(self.residual_mode).replace("torch.", "")
            ),
            "mean_cycle_time_s": solve_time / max(k, 1),
            "outer_loop": "host",
            "solve_time_s": solve_time,
        }
        return self._deliver(x, df, device_native, info), info

    def _say(self, k, rnorm):
        if self.config.verbose:
            print(f"[openmg_tpu_torch] cycle {k}: ‖r‖ = {rnorm:.3e}")

    def _loop_df_exact(self, b_df, x, cycle, limit, threshold):
        """Constant fine operator with dyadic taps: per cycle one V-cycle
        and one launch of the double-float update/residual kernel."""
        b_hi, b_lo = b_df
        offs = self.hierarchy.fine_hi.offsets
        terms = self._exact_terms
        if x is None:
            # the residual of the zero iterate is b itself
            x_hi = torch.zeros_like(b_hi)
            x_lo = torch.zeros_like(b_hi)
            r = b_hi
            rn = torch.sqrt(torch.sum(b_hi * b_hi))
        else:
            x_hi, x_lo = x
            r_pair, rn = _residual_norm_df_exact(offs, terms, b_df, x)
            r = r_pair[0]
        rnorm = float(rn)  # one scalar read
        history = [rnorm]
        self._say(0, rnorm)
        k = 0
        converged = rnorm < threshold
        while not converged and k < limit:
            e = cycle(r)
            x_hi, x_lo, r, pn = kernels.df_update_residual_const_3d(
                offs, terms, x_hi, x_lo, e, b_hi, b_lo, emit_norm=True
            )
            rnorm = float(torch.sqrt(torch.sum(pn)))  # one scalar read
            k += 1
            history.append(rnorm)
            self._say(k, rnorm)
            converged = rnorm < threshold
        return (x_hi, x_lo), history, converged

    def _loop(self, resid, update, x, cycle, limit, threshold):
        """The general outer loop: ``resid(x) -> (r, ‖r‖)`` before every
        cycle, ``update(x, e)`` after it."""
        history = []
        converged = False
        for k in range(limit + 1):
            r, rn = resid(x)
            rnorm = float(rn)  # one scalar read
            history.append(rnorm)
            self._say(k, rnorm)
            if rnorm < threshold:
                converged = True
                break
            if k == limit:
                break
            x = update(x, cycle(r.to(torch.float32)))
        return x, history, converged

    def solve_many(self, bs, x0s=None):
        raise NotImplementedError(
            "solve_many is not ported yet (ROADMAP queue 1, item 13)"
        )

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
    if config.dtype != "float32":
        raise NotImplementedError(
            f"dtype={config.dtype!r}: the cycle is ported for float32 only"
        )
    rmode = _resolve_residual_mode(config.residual_dtype) or torch.float32
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
        dtype=torch.float32,
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
