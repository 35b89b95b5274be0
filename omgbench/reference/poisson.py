"""Reference of the ``poisson`` problem kind: the (2d+1)-point Dirichlet
Poisson operator on the configuration's grid, applied by shifts."""

from __future__ import annotations

from omgbench.reference import stencil


def prepare(inputs: dict, device):
    return None


def residual_norm(op, b, x) -> float:
    return stencil.norm(stencil.poisson_residual(b, x))
