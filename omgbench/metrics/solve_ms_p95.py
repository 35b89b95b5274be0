"""``solve_ms_p95`` (end to end, host clock): the 95th percentile of the
window's call times, in ms, over every call (a ``solve``, or a
``solve_many`` of the whole batch), from the call to its solution ready."""

import statistics


def read(run):
    ms = [(c.t1 - c.t0) * 1e3 for c in run.calls]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
