"""case_setup_s.sweep: host seconds per case outside every `run_case` of the
window (the deck's voxelization and each case's flags, forcing and initial
state in `run/modes.py::run_datagen_mode`), by the benchmark's wrapper
around `run_case`."""

LAYER = "set-up"
MOVES = "case_s"


def read(run):
    if not run.cases_done:
        return None
    lo, hi = run.window_start, run.window_start + run.window_s
    # the window's time inside a run_case or the profiler's start and stop
    spans = sorted([(max(c.enter, lo), min(c.exit, hi)) for c in run.cases]
                   + [(max(a, lo), min(b, hi)) for a, b in run.pauses])
    inside, end = 0.0, lo
    for a, b in spans:
        if b <= end:
            continue
        inside += b - max(a, end)
        end = b
    return (run.window_s - inside) / run.cases_done
