"""vk_device_ms: device milliseconds per traced step of the operations
launched from inside the port's `luw.vk.refresh` span (the inlet hook's
pure-DDF variant, `bc/vk_inlet.py`): the launch calls paired with the card's
operations in the order of its one stream, and each kernel name's side of
the span carried past the records the profiler lost
(`spans.launched_within`)."""

from luwbench import spans

LAYER = "VK refresh"
MOVES = "mlups"


def read(run):
    device_s = spans.launched_within(run.trace, "vk.refresh")
    if device_s is None or not run.trace_steps:
        return None
    return 1e3 * device_s / run.trace_steps
