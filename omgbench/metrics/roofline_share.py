"""``roofline_share`` (layer ``kernels``: ``ops/``, ``csrc/``; device trace):
the bytes the traced calls' solves need at the least, over the device's
busy time at the card's data-sheet bandwidth, in %.  Moves ``mdof_per_s``.

The bytes are counted from the configuration file's levels (shapes and
kinds, never the program's storage) and the cycles the calls took, each
input read once and each output written once, in float32 (4 bytes a
value), as ``chip_smoke.py``'s ``k1_bound``, ``k2_bound``, ``sweep_bound``
and ``leg_bound`` count one kernel (frozen here):

* a visit of a level of n points above a level of n_c: the way down reads
  b and writes x and the restricted residual, 4(2n + n_c); the way up reads
  b, x and the coarse correction and writes x, 4(3n + n_c); a level of
  ``grids`` coefficient grids (a varying one) reads them once a leg, two
  legs a visit, once for all members of a batch;
* the coarsest level: its dense inverse read once a step for all members,
  4 n_c², and a member's vectors in and out, 2 · 4 n_c;
* an outer step: b and x as double-float pairs and the correction read,
  the pair and the residual written, 32 bytes a fine point a member; a
  general fine operator's hi and lo coefficient grids read once a step;
* a call's start: b read once a member for the first norm.

A step's members are those still running (a batch narrows as members
converge).  The same work counts the same whatever kernels do it.  Each
fine-level array (67 MB at 256³) and the dense inverse (67 MB at 16³) is
larger than the card's 50 MB L2, and they hold nearly all of these bytes,
so the busy time cannot be shorter than the bytes at the data-sheet rate:
a share above 100 % means the bytes or the busy time are wrong.
"""

import math

# H100 SXM data sheet, HBM3 (the card's power limit is printed beside the run)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
F32 = 4


def step_bytes(config):
    """``(shared, member)`` bytes of one outer step: what the step reads
    once whatever its members, and what it moves for each member."""
    levels = config["levels"]
    shared = member = 0
    for fine, coarse in zip(levels[:-1], levels[1:]):
        n, nc = math.prod(fine["shape"]), math.prod(coarse["shape"])
        member += F32 * (2 * n + nc) + F32 * (3 * n + nc)
        shared += 2 * F32 * fine.get("grids", 0) * n
    nc = math.prod(levels[-1]["shape"])
    shared += F32 * nc * nc
    member += 2 * F32 * nc
    n0 = math.prod(levels[0]["shape"])
    member += 8 * F32 * n0
    shared += 2 * F32 * config["outer"].get("grids", 0) * n0
    return shared, member


def call_bytes(config, cycles):
    """Bytes a call needs whose members took ``cycles`` outer steps."""
    shared, member = step_bytes(config)
    n0 = math.prod(config["levels"][0]["shape"])
    total = len(cycles) * F32 * n0
    for s in range(1, max(cycles) + 1):
        total += shared + member * sum(1 for c in cycles if c >= s)
    return total


def read(run):
    t = run.trace
    peak = PEAK_BYTES_PER_S.get(run.kind)
    if t is None or t.busy_s <= 0.0 or peak is None:
        return None
    nbytes = sum(call_bytes(run.config, c.cycles)
                 for c in run.calls[t.first:t.first + t.count])
    return 100.0 * nbytes / (t.busy_s * peak)
