"""``idle_share`` (layer ``device``; device trace): the share of the traced
window in which no kernel, copy or fill ran on the device, in %.  Moves
``solve_ms_p95``."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
