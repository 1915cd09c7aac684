"""solve_s.sweep: the mean of the program's own RunResult.solver_seconds
over the window's cases."""

LAYER = "driver"
MOVES = "case_s"


def read(run):
    if not run.cases:
        return None
    return sum(c.solver_seconds for c in run.cases) / len(run.cases)
