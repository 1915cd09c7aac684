"""case_s: all of the window's time over the whole cases completed in it,
each with its set-up, its solve and its written outputs."""

LAYER = "end to end"
MOVES = "case_s"


def read(run):
    if not run.cases_done:
        return None
    return run.window_s / run.cases_done
