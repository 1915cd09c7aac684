"""idle_setup_pct.sweep: the share of the traced stretch (one case) in
which the card runs nothing while the host is inside the port's
`luw.setup.case` span (the case's build in `run/modes.py`), over the
stretch as `device_idle_pct.sweep` takes it."""

from luwbench import spans

LAYER = "device"
MOVES = "case_s"


def read(run):
    inside = spans.idle_within(run.trace, "setup.case")
    if inside is None or run.trace.window_s <= 0:
        return None
    return 100.0 * inside / run.trace.window_s
