"""case_build_s.sweep: seconds of the traced stretch (one case with its
set-up) inside the port's `luw.setup.case` span: the case's build in
`run/modes.py`, from releasing the previous case's state to the new case's
flags, forcing and initial state."""

from luwbench import spans

LAYER = "set-up"
MOVES = "case_s"


def read(run):
    return spans.seconds(run.trace, "setup.case")
