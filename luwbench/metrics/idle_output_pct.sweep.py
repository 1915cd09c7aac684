"""idle_output_pct.sweep: the share of the traced stretch (one case) in
which the card runs nothing while the host is inside the port's
`luw.output` span (`write_final_outputs`), over the stretch as
`device_idle_pct.sweep` takes it."""

from luwbench import spans

LAYER = "device"
MOVES = "case_s"


def read(run):
    inside = spans.idle_within(run.trace, "output")
    if inside is None or run.trace.window_s <= 0:
        return None
    return 100.0 * inside / run.trace.window_s
