"""Solver / problem configuration (twin of ``openmg_tpu/core/config.py``).

Pure Python, copied: the same frozen dataclasses, field names, defaults,
validation and JSON round-trip, so a configuration written for the JAX
package drives the port unchanged.  ``MeshConfig`` comes with the
distributed solver (:mod:`openmg_tpu_torch.parallel.dist`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

__all__ = ["SolverConfig", "ProblemConfig", "MeshConfig"]


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
        device) or "auto" (default; the port resolves it to doublefloat, or
        to float64 for a float64 cycle); "float32" and "float64" evaluate
        the residual in that plain type.
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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process layout of the distributed solver: one rank a process, one
    device a rank, grid axis 0 cut into contiguous slabs over the ranks.

    n_devices: ranks along the partition axis (None: the whole world
        group).
    axis_name: the partition axis's name (kept for configuration
        compatibility; a rank's place on the axis is its group rank).
    min_rows_per_device: a level whose axis-0 slab would fall below this
        many planes (or lose factor-2 divisibility) is replicated instead
        of partitioned.
    overlap_halo: kept so the JAX package's configurations load; the port
        reads it nowhere: partitioned levels always run the halo forms of
        the stencil kernels, which consume the received planes inside the
        kernel.
    mesh_shape: optional ``(n_hosts, chips_per_host)``: the partition axis
        spans both axes in host-major order; None is a 1D mesh of
        ``n_devices``.
    axis_names: the two axes' names with ``mesh_shape``.
    force_partition: mark levels partitioned even on one rank, whose halos
        are then zero planes: the per-rank program of a larger mesh runs on
        one device.
    """

    n_devices: Optional[int] = None
    axis_name: str = "x"
    min_rows_per_device: int = 2
    overlap_halo: bool = True
    mesh_shape: Optional[tuple] = None
    axis_names: tuple = ("host", "chip")
    force_partition: bool = False
