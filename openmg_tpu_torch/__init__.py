"""openmg_tpu_torch — the PyTorch / CUDA port of ``openmg_tpu``.

Geometric multigrid for sparse SPD systems on regular grids, on one NVIDIA
GPU (Hopper, ``sm_90a``).  The package mirrors the JAX package's layout
(``core/``, ``ops/``, ``models/``, ``utils/``) and public names, so every
function here has a named twin there; it imports ``torch``, ``numpy`` and
``scipy`` and nothing of the JAX package.

What is ported so far is the 3D defect-correction solve of the stencil
engine: Poisson from a grid shape (structured setup, constant and cornered
levels), and any radius-1 stencil pair such as variable-coefficient
diffusion or a matrix's extracted stencil (host Galerkin chain, varying
levels); V(pre, post) cycles with Jacobi or red-black smoothing and
aggregate or linear transfers; the double-float outer loop and the plain
float32 / float64 ones.  Its kernels are hand-written CUDA under ``csrc/``,
built with ``nvcc`` at first use (:mod:`openmg_tpu_torch._build`):

* ``ops/fused.py::fused_stages_const_3d`` — a level visit on a constant or
  cornered level;
* ``ops/kernels.py::df_update_residual_const_3d`` — the outer step of a
  dyadic constant fine operator;
* ``ops/kernels.py`` ``residual_* / jacobi_* / rbgs_*`` ``_const_3d`` and
  ``_vary_3d`` — one smoother or residual pass, for the levels and residuals
  the other two do not take.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on
CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

from openmg_tpu_torch.core.config import ProblemConfig, SolverConfig
from openmg_tpu_torch.core.hierarchy import Hierarchy, Level
from openmg_tpu_torch.core.solver import Solver, mg_solve, setup, solve
from openmg_tpu_torch.models.poisson import (
    diffusion,
    diffusion_stencil,
    poisson,
    poisson_stencil,
    rhs_ones,
    rhs_random,
    stencil_from_csr,
    stencil_to_csr,
)
from openmg_tpu_torch.ops.stencil import CorneredOperator, StencilOperator

__version__ = "0.1.0"

__all__ = [
    "mg_solve",
    "solve",
    "setup",
    "Solver",
    "SolverConfig",
    "ProblemConfig",
    "Hierarchy",
    "Level",
    "poisson",
    "poisson_stencil",
    "stencil_to_csr",
    "stencil_from_csr",
    "diffusion",
    "diffusion_stencil",
    "rhs_random",
    "rhs_ones",
    "StencilOperator",
    "CorneredOperator",
]
