"""ksc_roofline: the least time of the traced stretch's K-SC steps (the
frozen bytes and operations of `counts.py` against the published peaks) over
their device time: the tiled step kernel and the VK site pass it launches,
by kernel name from the profiler."""

LAYER = "K-SC"
MOVES = "mlups"
STEP = "stream_collide_tiled_kernel"
KERNELS = (STEP, "vk_site_kernel")


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.kernels(KERNELS)
    steps = sum(1 for op in ops if STEP in op[0])
    busy = sum(b - a for _, _, a, b in ops)
    if not steps or busy <= 0:
        return None
    return 100.0 * steps * run.work["ksc_step_s"] / busy
