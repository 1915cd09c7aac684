"""output_copy_s.sweep: seconds of the traced stretch (one case) inside the
port's `luw.output.copy` spans: `write_final_outputs`'s copies of the
state, the accumulators and the flags to the host."""

from luwbench import spans

LAYER = "output"
MOVES = "case_s"


def read(run):
    return spans.seconds(run.trace, "output.copy")
