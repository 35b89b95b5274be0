"""Reference of the ``diffusion`` problem kind: the operator rebuilt from
the medium κ the benchmark drew (harmonic face means), applied by shifts."""

from __future__ import annotations

import torch

from omgbench.reference import stencil


def prepare(inputs: dict, device):
    kappa = torch.as_tensor(inputs["kappa"], dtype=torch.float64).to(device)
    return stencil.diffusion_stencil(kappa)


def residual_norm(op, b, x) -> float:
    offsets, coeffs = op
    return stencil.norm(stencil.stencil_residual(offsets, coeffs, b, x))
