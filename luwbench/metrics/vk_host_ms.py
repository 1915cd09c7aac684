"""vk_host_ms: host milliseconds per call of the inlet hook's pure-DDF
variant, timed by the benchmark's wrapper around it in the traced run
before the profiler starts: each timed call made after the card has run
out of work, so the time is the refresh's own enqueue, with neither the
profiler's cost per operation nor a wait for a full launch queue in it."""

LAYER = "VK refresh"
MOVES = "mlups"


def read(run):
    if not run.vk_host_s:
        return None
    return 1e3 * sum(run.vk_host_s) / len(run.vk_host_s)
