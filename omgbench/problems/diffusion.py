"""The ``diffusion`` problem kind: a medium κ drawn on the device from the
seed, ``low + width·U[0, 1)`` a cell, handed to the program as a user
does: ``setup(diffusion_stencil(κ), ...)`` on the host's float64 copy."""

from __future__ import annotations

import time

import torch


def make(config: dict, generator) -> dict:
    import openmg_tpu_torch as mg

    shape = tuple(config["shape"])
    med = config["medium"]
    g = generator("medium")
    kappa = torch.rand(shape, generator=g, device=g.device, dtype=torch.float64)
    kappa.mul_(med["width"]).add_(med["low"])
    kappa = kappa.cpu().numpy()
    t0 = time.perf_counter()
    problem = mg.diffusion_stencil(kappa, harmonic=True)
    return {
        "setup": problem,
        "reference": {"kappa": kappa},
        "spans": {"stencil_s": time.perf_counter() - t0},
    }
