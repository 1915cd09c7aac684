"""output_s.sweep: per case, the wall time of `run_case` from the benchmark's
wrapper less its solver_seconds (the final outputs: the fields, the derived
turbulence fields, the VTK writer), averaged over the window's cases."""

LAYER = "output"
MOVES = "case_s"


def read(run):
    if not run.cases:
        return None
    return sum(c.exit - c.enter - c.solver_seconds for c in run.cases) / len(run.cases)
