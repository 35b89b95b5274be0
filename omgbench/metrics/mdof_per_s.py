"""``mdof_per_s`` (end to end, host clock): millions of unknowns solved to
the configuration's threshold a second of the window — every right-hand
side whose call reported it converged, over the window's seconds
(HPGMG's DOF/s)."""


def read(run):
    solved = sum(sum(1 for ok in c.converged if ok) for c in run.calls)
    return solved * run.unknowns / run.window_s / 1e6
