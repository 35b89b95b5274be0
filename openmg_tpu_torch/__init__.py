"""openmg_tpu_torch — the PyTorch / CUDA port of ``openmg_tpu``.

Geometric multigrid for sparse SPD systems on regular grids, on one NVIDIA
GPU (Hopper, ``sm_90a``).  The package mirrors the JAX package's layout
(``core/``, ``ops/``, ``models/``, ``utils/``) and public names, so every
function here has a named twin there; it imports ``torch``, ``numpy`` and
``scipy`` and nothing of the JAX package.

What is ported so far is the 3D Poisson defect-correction solve: structured
setup (constant and cornered levels), V(pre, post) cycles with Jacobi or
red-black smoothing and aggregate or linear transfers, and the double-float
outer loop.  Its two kernels are hand-written CUDA under ``csrc/``, built
with ``nvcc`` at first use (:mod:`openmg_tpu_torch._build`):

* ``ops/fused.py::fused_stages_const_3d`` — every level visit of the cycle;
* ``ops/kernels.py::df_update_residual_const_3d`` — the outer step.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on
CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

from openmg_tpu_torch.core.config import ProblemConfig, SolverConfig
from openmg_tpu_torch.core.hierarchy import Hierarchy, Level
from openmg_tpu_torch.core.solver import Solver, mg_solve, setup, solve
from openmg_tpu_torch.models.poisson import (
    poisson,
    poisson_stencil,
    rhs_ones,
    rhs_random,
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
    "rhs_random",
    "rhs_ones",
    "StencilOperator",
    "CorneredOperator",
]
