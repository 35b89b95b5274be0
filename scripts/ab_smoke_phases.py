#!/usr/bin/env python3
"""Run the kernel phases of a checkout's ``chip_smoke.py`` alone, so two
versions of the port can be timed in one call on one card.

    python3 scripts/ab_smoke_phases.py [--root DIR] [--phases fused2d sweeps]

Imports ``chip_smoke`` and ``openmg_tpu_torch`` from ``DIR`` (default: this
checkout; an earlier commit unpacked with ``git archive`` gives its own
kernels and its own checks) and runs ``env``, ``build``, then the phases
asked for: ``fused2d`` (K5 in every mode, timed), ``sweeps`` (K3 and K4
pass by pass and K4's legs, timed; it sets up the 256³ diffusion and
unfaced hierarchies first, as ``chip_smoke.py`` does).  Each phase prints
its own line as in ``chip_smoke.py`` and fails the same way.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if "--root" in sys.argv[:-1]:
    ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--phases", nargs="*", choices=("fused2d", "sweeps"),
                    default=["fused2d", "sweeps"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"root {ROOT}", flush=True)
    _, copy_bw = cs.phase_env(dev)
    cs.phase_build()
    if "fused2d" in args.phases:
        cs.phase_fused2d(dev, copy_bw)
    if "sweeps" in args.phases:
        unfaced = cs.setup_unfaced(dev)
        vary = cs.setup_vary(dev)
        cs.phase_sweeps(dev, copy_bw, vary[0].hierarchy, unfaced[0].hierarchy)


if __name__ == "__main__":
    main()
