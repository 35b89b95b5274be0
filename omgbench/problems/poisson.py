"""The ``poisson`` problem kind: a grid shape, from which the program
assembles the (2d+1)-point Dirichlet Poisson operator itself
(``setup(shape, ...)``), as a user of the shape entry point does."""

from __future__ import annotations


def make(config: dict, generator) -> dict:
    """``setup``: what ``openmg_tpu_torch.setup`` takes; ``reference``:
    what the reference of this kind rebuilds the operator from."""
    return {"setup": tuple(config["shape"]), "reference": {}, "spans": {}}
