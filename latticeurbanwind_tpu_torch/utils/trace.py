"""The port's own spans, on the profiler's clock.

`span(name)` marks a stretch of host work as `luw.<name>` in a running
`torch.profiler` trace, on the same nanosecond clock as the device's
events; a span's parent is the span that encloses it on the same thread.
With no profiler running it is one check of a Python flag and a shared
`nullcontext` (about 0.3 us on a CPU), where entering and leaving
`torch.profiler.record_function` costs about 8 us even then.  Spans live in
the profiler's memory and are written out by whoever runs the profiler.

A span is a function-scope record function (`_RecordFunctionFast`), like
the profiler's own `aten::` operations: it appears as a host event only.
A user-scope one (`record_function`) is also mirrored on the device as an
annotation that covers the kernels launched inside it, which a reader that
counts or unions the device's operations would take for work.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.autograd.profiler

PREFIX = "luw."
_OFF = nullcontext()


def span(name: str):
    """A context manager: the span `luw.<name>` while a profiler runs,
    else nothing."""
    # read through the modules at every call: the flag flips when a
    # profiler starts and stops
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
