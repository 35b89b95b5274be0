"""openmg_tpu_torch — the PyTorch / CUDA port of ``openmg_tpu``.

Geometric multigrid for sparse SPD systems on regular grids, on one NVIDIA
GPU (Hopper, ``sm_90a``).  The package mirrors the JAX package's layout
(``core/``, ``ops/``, ``models/``, ``utils/``) and public names, so every
function here has a named twin there; it imports ``torch``, ``numpy`` and
``scipy`` and nothing of the JAX package.

What is ported so far:

* the stencil engine's defect-correction solve on 1D, 2D and 3D grids:
  Poisson from a grid shape (structured setup, constant, cornered and faced
  levels), and any radius-1 stencil pair such as variable-coefficient
  diffusion or a matrix's extracted stencil (host Galerkin chain, or the
  same chain on the device with ``core.hierarchy.build_hierarchy_device``;
  varying levels); V, W and FMG cycles and MG-PCG with Jacobi, red-black or
  4th-kind Chebyshev smoothing and aggregate or linear transfers; the
  double-float outer loop and the plain float32 / float64 ones; a float64
  cycle on the CPU; the numpy oracle of the original algorithm
  (``utils/oracle.py``);
* the general sparse engine (:func:`setup_sparse`, and ``mg_solve`` with
  ``format`` ``ell|csr|bsr|dense`` or a matrix that is not
  stencil-representable): host Galerkin chain of explicit transfer
  matrices, levels in ELL / CSR / BSR / dense containers, Jacobi,
  multicolour Gauss–Seidel or Chebyshev smoothing, V and W cycles, vector
  problems with ``dofs`` unknowns a node (:func:`elasticity`,
  :func:`coupled_diffusion`);
* the distributed stencil engine (:func:`distributed_setup`,
  :class:`DistributedSolver`): levels cut into z-slabs over
  ``torch.distributed`` ranks (NCCL between cards, gloo on the CPU), halos
  read inside the kernels, coarse levels replicated; and the distributed
  general-sparse engine (:func:`setup_sparse_distributed`,
  :class:`DistributedAlgebraicSolver`): ELL levels cut into row blocks,
  banded ones with halo rows, irregular ones on gathered vectors;
* checkpoint/resume of a solve (``utils/checkpoint.py``), profiler traces
  and solve reports (``utils/observe.py``), and the command line
  (``python -m openmg_tpu_torch``).

Its kernels are hand-written CUDA under ``csrc/``, built with ``nvcc`` at
first use (:mod:`openmg_tpu_torch._build`):

* ``ops/fused.py::fused_stages_const_3d`` — a 3D level visit on a constant
  or cornered level;
* ``ops/kernels.py::fused_stages_2d`` — a 2D level visit;
* ``ops/kernels.py::df_update_residual_const_3d`` — the outer step of a
  dyadic constant fine operator;
* ``ops/kernels.py`` ``residual_* / jacobi_* / rbgs_*`` ``_const_3d`` and
  ``_vary_3d`` — one smoother or residual pass, for the levels and residuals
  the others do not take;
* ``ops/ell.py::spmv_ell`` and ``ops/bsr.py::spmv_bsr`` — the SpMV of a
  banded ELL and of a blocked-band BSR level of the sparse engine;
* the halo forms of the first four (``halos=``, and
  ``kernels.halo_half_sweep_const_3d`` / ``_vary_3d``) and of the ELL SpMV
  (``ops/ell.py::spmv_banded_halo``) — the same work on a rank's slab with
  the planes or rows received from its neighbours.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on
CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

from openmg_tpu_torch.core.algebraic import AlgebraicSolver, setup_sparse
from openmg_tpu_torch.core.config import MeshConfig, ProblemConfig, SolverConfig
from openmg_tpu_torch.core.hierarchy import Hierarchy, Level, build_hierarchy
from openmg_tpu_torch.core.solver import Solver, mg_solve, setup, solve
from openmg_tpu_torch.models.elasticity import coupled_diffusion, elasticity
from openmg_tpu_torch.models.poisson import (
    diffusion,
    diffusion_stencil,
    poisson,
    poisson_ell_device,
    poisson_stencil,
    rhs_ones,
    rhs_random,
    stencil_from_csr,
    stencil_to_csr,
)
from openmg_tpu_torch.ops.sparse import (
    BSRMatrix,
    CSRMatrix,
    ELLMatrix,
    from_scipy,
    to_scipy,
)
from openmg_tpu_torch.ops.stencil import CorneredOperator, StencilOperator
from openmg_tpu_torch.parallel.dist import DistributedSolver, distributed_setup
from openmg_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from openmg_tpu_torch.parallel.sparse_dist import (
    DistributedAlgebraicSolver,
    setup_sparse_distributed,
)

__version__ = "0.1.0"

__all__ = [
    "mg_solve",
    "solve",
    "setup",
    "setup_sparse",
    "Solver",
    "AlgebraicSolver",
    "SolverConfig",
    "ProblemConfig",
    "MeshConfig",
    "DistributedSolver",
    "distributed_setup",
    "DistributedAlgebraicSolver",
    "setup_sparse_distributed",
    "initialize_distributed",
    "make_mesh",
    "Hierarchy",
    "Level",
    "build_hierarchy",
    "poisson",
    "poisson_stencil",
    "stencil_to_csr",
    "stencil_from_csr",
    "diffusion",
    "diffusion_stencil",
    "poisson_ell_device",
    "elasticity",
    "coupled_diffusion",
    "rhs_random",
    "rhs_ones",
    "CSRMatrix",
    "ELLMatrix",
    "BSRMatrix",
    "from_scipy",
    "to_scipy",
    "StencilOperator",
    "CorneredOperator",
]
