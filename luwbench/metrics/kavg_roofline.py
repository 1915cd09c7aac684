"""kavg_roofline: the least time of the traced stretch's averaging
samples (the frozen bytes and operations of `counts.py`) over the device
time of the K-AVG launches, by kernel name from the profiler."""

LAYER = "K-AVG"
MOVES = "mlups"
KERNEL = "avg_update_kernel"


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.kernels((KERNEL,))
    busy = sum(b - a for _, _, a, b in ops)
    if not ops or busy <= 0:
        return None
    return 100.0 * len(ops) * run.work["kavg_sample_s"] / busy
