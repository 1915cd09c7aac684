"""The device trace of a traced stretch, reduced to what the readers need.

`Tracer` wraps `torch.profiler` (CPU and CUDA activity) around a stretch of
the window that the harness chooses, synchronising every card used at both
ends.  `Trace` holds, in seconds on one clock: every device operation
(kernels, copies, memsets) with its card, the benchmark's own host spans
(`span`, recorded as profiler annotations), and the host operations, which
name what the host was doing during the device's idle gaps.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

SPAN_PREFIX = "luwbench."


@contextmanager
def span(name: str, enabled: bool):
    """A host span of the benchmark's own, in the trace when tracing."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


@dataclass
class Trace:
    window_s: float
    devices: Tuple[int, ...]
    # (name, card, start s, end s), start-sorted, times relative to the
    # first event of the stretch
    device_ops: List[Tuple[str, int, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    def busy_s(self, card: int) -> float:
        """Seconds in which an operation ran on `card` (the union of its
        operations' intervals)."""
        total, end = 0.0, None
        for _, dev, a, b in self.device_ops:
            if dev != card:
                continue
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def kernels(self, patterns: Sequence[str]) -> List[Tuple[str, int, float, float]]:
        return [op for op in self.device_ops
                if any(p in op[0] for p in patterns)]

    def span_seconds(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.spans if n == name]

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, _, a, b in self.device_ops:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:200], v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations on the first card,
        each named by the benchmark span and the innermost host operation
        in progress at its middle."""
        card = self.devices[0]
        gaps, end = [], None
        for _, dev, a, b in self.device_ops:
            if dev != card:
                continue
            if end is not None and a > end:
                gaps.append((a - end, end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            out.append([self._host_label(mid), length])
        return out

    def _host_label(self, t: float) -> str:
        def innermost(items):
            best = None
            for name, a, b in items:
                if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                    best = (name, a, b)
            return best[0] if best else None

        sp = innermost(self.spans) or "outside spans"
        op = innermost(self.host_ops) or "host idle or in Python"
        return f"{sp} / {op}"[:200]


class Tracer:
    """Profile one stretch: `start()` and `stop()` synchronise the cards
    in `devices`; `stop()` returns the reduced `Trace`, whose `window_s` is
    the stretch's host time, or its device operations' span on a card
    where that reads longer."""

    def __init__(self, devices: Sequence[int]):
        self.devices = tuple(devices)
        self.prof = None
        self.t0 = 0.0

    def _sync(self) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)

    def warm(self) -> None:
        """Start and stop the profiler once (set-up): its first start
        initialises the device tracing, seconds that belong outside the
        window."""
        self.start()
        torch.zeros(1, device=f"cuda:{self.devices[0]}").add_(1)
        self.stop()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        self._sync()
        window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        dev_ops, spans, host = [], [], []
        for ev in events:
            a = _ns(ev, "start")
            b = a + _ns(ev, "duration")
            kind = str(ev.device_type())
            name = ev.name()
            if name.startswith(SPAN_PREFIX):
                # a span is recorded on the host and mirrored on the device
                if not kind.endswith("CUDA"):
                    spans.append((name[len(SPAN_PREFIX):], a, b))
            elif kind.endswith("CUDA"):
                if "Sync" in name:      # a wait the profiler may record, not work
                    continue
                dev_ops.append((name, int(ev.device_index()), a, b))
            elif b > a:
                host.append((name, a, b))
        self.prof = None
        origin = min([x[2] for x in dev_ops] + [x[1] for x in spans + host] or [0])
        s = 1e-9
        dev_ops.sort(key=lambda x: x[2])
        # the profiler's device timestamps can read a stretch a few percent
        # longer than the host clock does: the window is the longer of the
        # two, so that a card's busy time never exceeds it
        for d in self.devices:
            on = [(a, b) for _, dev, a, b in dev_ops if dev == d]
            if on:
                window = max(window, (max(b for _, b in on) - min(a for a, _ in on)) * s)
        return Trace(
            window_s=window, devices=self.devices,
            device_ops=[(n, d, (a - origin) * s, (b - origin) * s)
                        for n, d, a, b in dev_ops],
            spans=[(n, (a - origin) * s, (b - origin) * s) for n, a, b in spans],
            host_ops=[(n, (a - origin) * s, (b - origin) * s) for n, a, b in host])
