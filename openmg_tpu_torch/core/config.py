"""Solver / problem configuration (twin of ``openmg_tpu/core/config.py``).

Pure Python, copied: the same frozen dataclasses, field names, defaults,
validation and JSON round-trip, so a configuration written for the JAX
package drives the port unchanged.  ``MeshConfig`` comes with the
distributed slice.  Options the port does not run yet are accepted here
(the vocabulary is shared) and refused where they would be used, with
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

__all__ = ["SolverConfig", "ProblemConfig"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Multigrid solver configuration.

    gridlevels: number of levels (None → full depth by factor-2 coarsening).
    pre_iterations: pre-smoothing sweeps per level visit (reference
        ``iterations``).
    post_iterations: post-smoothing sweeps (reference default had none;
        build default 1 for a symmetric cycle).
    cycles: max outer V-cycles (0 → unlimited-with-safety-cap).
    threshold: absolute ‖r‖₂ convergence target (reference semantics).
    smoother: "jacobi" | "rbgs" | "chebyshev" (4th-kind Chebyshev
        polynomial smoothing — order-free like Jacobi but with an
        optimal-polynomial damping schedule; `iterations` is the
        polynomial degree).
    cycle_type: "v" (reference-parity V-cycle) | "w" (W-cycle: two coarse
        visits per level — more robust, ~2x coarse work) | "f" (full
        multigrid: coarsest-first pass, ~1.3x a V-cycle per pass and
        roughly halves the outer cycle count).
    krylov: "none" (pure multigrid, reference-parity) | "pcg" — each outer
        defect-correction step runs `krylov_iters` MG-preconditioned
        conjugate-gradient iterations instead of one bare cycle; the
        robust choice for rough/jumping coefficients.
    krylov_iters: CG iterations (= cycles) per outer step with krylov="pcg".
    omega: weighted-Jacobi damping (2/3 is optimal for 1D Poisson; a robust
        all-round default).
    dtype: cycle computation dtype: float32, or float64 on the CPU only
        (the stencil kernels are float32).
    transfer: intergrid transfer spec — "aggregate" is the reference's
        piecewise-constant scheme (parity default); "linear" is
        vertex-centered full-weighting/linear interpolation (much better
        convergence rate; recommended for performance runs).
    residual_dtype: outer residual / iterative-refinement precision; the
        f32 V-cycle acts as the preconditioner of a defect-correction loop
        evaluated at this precision, which is how 1e-10 absolute residuals
        are reached (SURVEY.md §7 "Hard parts", Plan A).  Choices:
        "doublefloat" (two-f32 compensated arithmetic, no f64 on the
        device) or "auto" (default; the port resolves it to doublefloat).
        "float64", "float32" and None name the reference's plain modes,
        which the port does not run yet.
    max_dense_coarse: largest coarsest-level size solved by the
        precomputed dense solve (T8).
    outer_loop: kept for configuration compatibility; the port always
        runs the outer loop on the host (one scalar read per cycle).
    format: operator storage for the cycle — "auto" (stencil fast path
        when the matrix is grid-structured, else ELL), or force one of
        "stencil" | "ell" | "csr" | "bsr" (the padded-static-nnz general
        containers, SURVEY.md T1) | "dense" (the reference's
        ``dense=True`` debug mode — densified operators; small problems
        only).
    blocksize: BSR block edge (square blocks) when format="bsr".
    """

    gridlevels: Optional[int] = None
    pre_iterations: int = 2
    post_iterations: int = 2
    cycles: int = 100
    threshold: float = 1e-10
    smoother: str = "rbgs"
    cycle_type: str = "v"
    krylov: str = "none"
    krylov_iters: int = 2
    omega: float = 2.0 / 3.0
    transfer: str = "aggregate"  # "aggregate" (reference-parity) | "linear"
    dtype: str = "float32"
    residual_dtype: Optional[str] = "auto"
    setup_dtype: str = "float32"  # RAP-chain precision (see build_hierarchy)
    max_dense_coarse: int = 512
    min_coarse_dim: int = 1
    format: str = "auto"
    blocksize: int = 4
    outer_loop: str = "auto"
    verbose: bool = False

    def __post_init__(self):
        # fail at construction, not deep inside a solve
        _check = {
            "smoother": ("jacobi", "rbgs", "chebyshev"),
            "cycle_type": ("v", "w", "f"),
            "krylov": ("none", "pcg", None),
            "transfer": ("aggregate", "linear"),
            "format": ("auto", "stencil", "ell", "csr", "bsr", "dense"),
            "outer_loop": ("auto", "device", "host"),
        }
        for field, allowed in _check.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"{field}={v!r}; choose from "
                    f"{sorted(str(a) for a in allowed if a is not None)}"
                )

    @staticmethod
    def from_parameters(parameters: dict) -> "SolverConfig":
        """Translate a reference-style ``parameters`` dict (R7 vocabulary)."""
        p = dict(parameters)
        known = {
            "gridlevels": p.pop("gridlevels", None),
            "pre_iterations": p.pop("iterations", 2),
            "cycles": p.pop("cycles", 100),
            "threshold": p.pop("threshold", 1e-10),
            "verbose": p.pop("verbose", False),
        }
        p.pop("problemshape", None)  # carried by ProblemConfig
        if p.pop("dense", False):  # reference debug toggle → dense engine
            known["format"] = "dense"
        for extra in (
            "post_iterations",
            "smoother",
            "cycle_type",
            "krylov",
            "krylov_iters",
            "omega",
            "transfer",
            "dtype",
            "residual_dtype",
            "setup_dtype",
            "max_dense_coarse",
            "min_coarse_dim",
            "format",
            "blocksize",
            "outer_loop",
        ):
            if extra in p:
                known[extra] = p.pop(extra)
        if p:
            raise ValueError(f"unknown parameters: {sorted(p)}")
        return SolverConfig(**known)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "SolverConfig":
        return SolverConfig(**json.loads(s))


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Problem description: a Poisson grid (reference `problemshape`)."""

    shape: Tuple[int, ...]
    rhs: str = "random"  # "random" | "ones"
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)
