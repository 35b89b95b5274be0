"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 -m omgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the output check compared, with its limit (also the last lines of
standard error).  Exits non-zero and prints no result without a CUDA
device, with fewer devices than the cell asks for, or when JAX or the JAX
package is loaded once the window has closed.

``--control`` runs the configuration's ``control`` settings (the program's
lower-precision path) in the solver's place: such a run has to come out
not correct.  The benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from omgbench import spec as specs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m omgbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    # the program's caches inside the checkout, at fixed paths (the port's
    # nvcc build is openmg_tpu_torch/_build/, fixed by the port)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(specs.ROOT / ".omgbench_cache" / sub))

    import torch

    bench = specs.load()
    chips = specs.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available():
        print("omgbench: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"omgbench: {args.workload} needs {chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    from omgbench import harness

    result, spans = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), t_start=T_START, control=args.control,
    )
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"omgbench: {', '.join(loaded)} loaded in the measuring process",
              file=sys.stderr)
        return 3
    print("set-up " + " ".join(f"{k} {v:.3f}" for k, v in spans.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
