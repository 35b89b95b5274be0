"""omgbench — the benchmark of ``openmg_tpu_torch`` on NVIDIA GPUs.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix):

    python3 -m omgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It sets the solver up as a user does, calls it back to back for the
window, checks a sample of the answers against a plain float64 reference,
and prints one JSON line.  Everything that belongs to one configuration,
traffic mix or metric is a file found by its name:

* ``configs/<config>.json`` — the problem, its solver settings, its source
  and cuts, and the level shapes and kinds the byte model counts;
* ``traffic/<mix>.json`` — the call, the batch, the pool of right-hand
  sides, the answers checked and the calls traced;
* ``problems/<kind>.py`` — how the inputs of a problem kind are made and
  handed to the program;
* ``reference/<kind>.py`` — the plain float64 reference of a problem kind
  (torch and numpy only, nothing of the program);
* ``metrics/<metric>.py`` — one reader a metric, ``read(run)``.

Nothing here imports JAX or the JAX package; ``run.py`` refuses to print a
result if either is loaded.
"""
