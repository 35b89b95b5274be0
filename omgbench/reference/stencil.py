"""Float64 stencil arithmetic by shifts, no matrix (frozen copies).

``poisson_residual`` is ``chip_smoke.py::residual_norm_host`` and
``stencil_residual`` is ``chip_smoke.py::residual_norm_host_stencil``, in
torch so that they run on the card once the program's state is freed (and
on the CPU in the tests); ``diffusion_stencil`` is
``openmg_tpu_torch/models/poisson.py::diffusion_stencil`` with harmonic
face means.  Grids are C-ordered, the operator Dirichlet: a neighbour
outside the grid is zero.
"""

from __future__ import annotations

import torch


def poisson_offsets(ndim: int) -> tuple:
    """Offsets of the (2d+1)-point operator: the centre, then −1 and +1
    along each axis."""
    offs = [(0,) * ndim]
    for axis in range(ndim):
        for s in (-1, 1):
            o = [0] * ndim
            o[axis] = s
            offs.append(tuple(o))
    return tuple(offs)


def poisson_residual(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``b − A x`` of the (2d+1)-point Poisson operator (diagonal 2d, −1 a
    face neighbour)."""
    d = x.ndim
    ax = 2.0 * d * x
    for axis in range(d):
        lo = [slice(None)] * d
        hi = [slice(None)] * d
        lo[axis] = slice(0, -1)
        hi[axis] = slice(1, None)
        ax[tuple(lo)] -= x[tuple(hi)]
        ax[tuple(hi)] -= x[tuple(lo)]
    return b - ax


def stencil_residual(offsets, coeffs, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``b − A x`` from per-offset coefficient grids: ``coeffs[k][i]`` is
    ``A[i, i + offsets[k]]``."""
    r = b.clone()
    for k, off in enumerate(offsets):
        src = tuple(slice(max(0, o), x.shape[a] + min(0, o)) for a, o in enumerate(off))
        dst = tuple(slice(max(0, -o), x.shape[a] - max(0, o)) for a, o in enumerate(off))
        r[dst] -= coeffs[k][dst] * x[src]
    return r


def diffusion_stencil(kappa: torch.Tensor):
    """``−∇·(κ∇u)`` in finite-volume form: the face coefficient between two
    cells is the harmonic mean of their κ, a wall face couples a cell to
    the boundary with its own κ (diagonal only), and the diagonal is the
    sum of the face coefficients.  Returns ``(offsets, coeffs)``."""
    kappa = kappa.to(torch.float64)
    shape = tuple(kappa.shape)
    d = len(shape)
    offsets = poisson_offsets(d)
    coeffs = torch.zeros((len(offsets),) + shape, dtype=torch.float64, device=kappa.device)
    k = 1
    for axis in range(d):
        lo = [slice(None)] * d
        hi = [slice(None)] * d
        lo[axis] = slice(0, shape[axis] - 1)
        hi[axis] = slice(1, None)
        a, c = kappa[tuple(lo)], kappa[tuple(hi)]
        f = 2.0 * a * c / (a + c)
        coeffs[k][tuple(hi)] = -f  # coupling to the −1 neighbour
        coeffs[k + 1][tuple(lo)] = -f  # coupling to the +1 neighbour
        k += 2
        wall_lo = [slice(None)] * d
        wall_hi = [slice(None)] * d
        wall_lo[axis] = slice(0, 1)
        wall_hi[axis] = slice(shape[axis] - 1, None)
        coeffs[0][tuple(wall_lo)] += kappa[tuple(wall_lo)]
        coeffs[0][tuple(wall_hi)] += kappa[tuple(wall_hi)]
    coeffs[0] -= coeffs[1:].sum(dim=0)
    return offsets, coeffs


def norm(r: torch.Tensor) -> float:
    return float(torch.sqrt(torch.sum(r * r)))
