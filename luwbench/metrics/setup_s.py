"""setup_s: from the process's start to the window's first step (imports,
the kernels' library, the deck's host set-up, the warm-up)."""

LAYER = "end to end"
MOVES = "setup_s"


def read(run):
    return run.setup_s
