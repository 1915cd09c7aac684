"""device_ops_per_step: device operations (kernels, copies, memsets) per
step in the traced stretch, counted by the profiler."""

LAYER = "stepper"
MOVES = "mlups"


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    return len(run.trace.device_ops) / run.trace_steps
