"""mlups: every cell update of the window (grid cells x steps enqueued, the
window closed by a synchronisation) over all of the window's time."""

LAYER = "end to end"
MOVES = "mlups"


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return run.grid_cells * run.steps / run.window_s / 1e6
