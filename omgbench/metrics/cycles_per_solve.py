"""``cycles_per_solve`` (layer ``solver loop``: ``core/solver.py``
``lockstep``, ``core/cycle.py``; program counter): the outer steps the
window's calls report (``info["cycles"]``, one a member) over the
right-hand sides they solved.  Moves ``mdof_per_s``."""


def read(run):
    members = sum(len(c.cycles) for c in run.calls)
    return sum(sum(c.cycles) for c in run.calls) / members
