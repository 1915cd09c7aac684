"""device_idle_pct.sweep: the share of the traced stretch in which the card runs
nothing (the union of its operations against the stretch's host time)."""

LAYER = "device"
MOVES = "case_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.mean_busy_s() / run.trace.window_s)
