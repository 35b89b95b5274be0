"""``launches_per_step`` (layer ``launch path``: ``core/cycle.py`` to the
``ops/*.py`` wrappers; device trace): device kernels that start in the
traced calls, over their outer steps (a step: one inner solve of all the
call's members, so a batch's step counts once).  Copies are not counted.
Moves ``solve_ms_p95``."""


def read(run):
    t = run.trace
    if t is None or t.kernels == 0:
        return None
    steps = sum(c.steps for c in run.calls[t.first:t.first + t.count])
    return t.kernels / steps
