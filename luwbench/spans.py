"""The port's own spans in a traced stretch, for the readers of
`metrics/`.

The port marks its layers with spans named `luw.<name>`
(`latticeurbanwind_tpu_torch/utils/trace.py`), recorded by the profiler
as host events of function scope with no mirror on the device: `Trace`
(`trace.py`) holds them among its host operations under their full names,
beside the runtime calls that launch the device's operations.  Every
helper reads the first card and the stretch from 0 to `window_s`, and
returns None where the stretch holds no such span.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "luw."
# the runtime and driver calls that put an operation on a card's stream
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
            "cudaMemset", "cuMemset")

Interval = Tuple[float, float]


def _union(intervals) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(xs: List[Interval], ys: List[Interval]) -> float:
    """Seconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def intervals(trace, name: str) -> Optional[List[Interval]]:
    """The union of the spans `luw.<name>` within the stretch, or None."""
    if trace is None:
        return None
    full = PREFIX + name
    found = [(max(a, 0.0), min(b, trace.window_s))
             for n, a, b in trace.host_ops if n == full]
    if not found:
        return None
    return _union((a, b) for a, b in found if b > a)


def seconds(trace, name: str) -> Optional[float]:
    """Seconds of the stretch inside the spans `luw.<name>`."""
    spans = intervals(trace, name)
    return None if spans is None else sum(b - a for a, b in spans)


def idle(trace) -> List[Interval]:
    """The stretch's intervals in which the first card runs nothing."""
    card = trace.devices[0]
    busy = _union((max(a, 0.0), min(b, trace.window_s))
                  for _, dev, a, b in trace.device_ops if dev == card)
    out, t = [], 0.0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < trace.window_s:
        out.append((t, trace.window_s))
    return out


def idle_within(trace, name: str) -> Optional[float]:
    """Seconds in which the first card is idle while the host is inside the
    spans `luw.<name>`."""
    spans = intervals(trace, name)
    return None if spans is None else _overlap(idle(trace), spans)


# the share of a stretch's operations that must pair for a reading
SURE_SHARE = 0.5
# the kind of a launch call and of the device operation it puts on the
# stream, by the start of their names; any other is a kernel
CALL_KINDS = (("cudaMemcpy", "copy"), ("cuMemcpy", "copy"),
              ("cudaMemset", "set"), ("cuMemset", "set"))
OP_KINDS = (("Memcpy", "copy"), ("Memset", "set"))


def _kind(name: str, kinds) -> str:
    for prefix, kind in kinds:
        if name.startswith(prefix):
            return kind
    return "kernel"


def launched_within(trace, name: str) -> Optional[float]:
    """Device seconds of the first card's operations launched from inside
    the spans `luw.<name>`.  The trace keeps no link from an operation to
    its call, and the profiler loses some records: of operations or of
    calls as it starts, at times of operations within the stretch.  So the
    kernel names carry the side.  One stream runs its operations in the
    order of their launches, and the stretch ends with every launch done:
    from the last, the calls and the operations pair off in order, each
    pair the same in kind (a copy's call with a copy) and the call no later
    than its operation, each kernel name's pairs all inside the spans or
    all outside.  The pairing stops at the first pair that breaks this
    (where a record was lost); the names' sides in the pairs before it
    give every operation of the stretch its side.  None where the stretch
    has operations on another card (the calls name no card), where fewer
    than `SURE_SHARE` of its operations paired, or where a kernel name
    never paired."""
    spans = intervals(trace, name)
    if spans is None:
        return None
    card = trace.devices[0]
    if any(dev != card for _, dev, _, _ in trace.device_ops):
        return None
    ops = [(n, a, b) for n, _, a, b in trace.device_ops]
    calls = sorted((a, n) for n, a, _ in trace.host_ops if n.startswith(LAUNCHES))
    inside, k = [], 0
    for c, _ in calls:
        while k < len(spans) and spans[k][1] < c:
            k += 1
        inside.append(k < len(spans) and spans[k][0] <= c)
    side, paired, shift = {}, 0, len(calls) - len(ops)
    for i in range(len(ops) - 1, -shift - 1 if shift < 0 else -1, -1):
        op, a, _ = ops[i]
        c, call = calls[i + shift]
        if a < c or _kind(call, CALL_KINDS) != _kind(op, OP_KINDS) \
                or side.setdefault(op, inside[i + shift]) != inside[i + shift]:
            break
        paired += 1
    if paired < SURE_SHARE * len(ops) or any(op not in side for op, _, _ in ops):
        return None
    return sum(b - a for op, a, b in ops if side[op])
