"""The general harness: one run of one cell, from its data files.

A run builds the cell's deck in a work directory under TMPDIR, builds what
the window needs with the program's own entry points and warms up on the
cell's own shapes (set-up, `setup_s`), measures for `--seconds`, closes the
window, reads the card's memory peak, then checks what the timed path
produced against the plain reference (`check.py`) and reads the metrics.

Windows (`window` in the cell's file):

  * "steps": `run/driver.py::run_case` on the case that the deck's mode
    builds; the benchmark's wrapper around the runner that `run_case`
    builds closes the window at the first runner call after `--seconds`
    (and, where the window averages, after an averaging sample that came
    after `--seconds`); every step enqueued before it counts, and the
    window ends with a synchronisation.
  * "cases": `run/modes.py::run_deck` on the whole deck, serially; the
    window ends when the first case whose last averaging sample came after
    `--seconds` has written its outputs (or the first case to end after
    `--seconds` that took another number of samples than the deck asks
    for, which the check then fails).

The program is reached only through its modules' functions; the wrappers
(`Probe`) count steps, averaging samples and cases, time the inlet hook
and the cases, keep what the check needs at the window's end (the state,
and the inputs and outputs of the window's last averaging sample), and
start and stop the traced stretch.  A watchdog ends a run whose window
never reaches the program's runner, or never closes.
"""

from __future__ import annotations

import _thread
import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import spec
from .trace import Trace, Tracer, span

FORBIDDEN = ("jax", "jaxlib", "flax", "latticeurbanwind_tpu")
# the traced run times the inlet's refresh on the host over these calls
# of the window, after passing the first ones
VK_SKIP, VK_TIMED = 50, 500


class WindowClosed(Exception):
    """Raised inside the program's loop to end the window."""


class Captured(Exception):
    """Raised from the program's `run_case` during set-up: the case is built."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


# -- the deck ---------------------------------------------------------------

def _deck_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_deck_value(x).strip('"') for x in v) + "]"
    if isinstance(v, str):
        return f'"{v}"'
    return repr(v)


def rotated(seq: list, k: int) -> list:
    k %= len(seq)
    return list(seq[k:]) + list(seq[:k])


def deck_keys(cell: spec.Cell, seed: int) -> dict:
    """The deck as this run runs it: the configuration's keys, the traffic's
    keys, and the seed (a deck key, or where the sweep starts in the rose)."""
    keys = dict(cell.config["deck"])
    keys.update(cell.workload.get("deck", {}))
    how = cell.workload["seed"]
    if "deck_key" in how:
        keys[how["deck_key"]] = int(seed)
    for key, per in how.get("rotate", {}).items():
        keys[key] = rotated(keys[key], int(seed) // int(per))
    return keys


def write_deck(cell: spec.Cell, keys: dict, work: Path, name: str) -> Path:
    """The configuration's raw inputs copied to `work/name` with the deck
    written from `keys`."""
    case = work / name
    shutil.copytree(cell.root / "configs" / cell.config["inputs"], case)
    deck = case / cell.config["deck_file"]
    deck.write_text("// deck written by the benchmark\n" + "".join(
        f"{k} = {_deck_value(v)}\n" for k, v in keys.items()))
    return deck


def sample_steps(keys: dict, t: Optional[int] = None) -> range:
    """The steps at which the deck asks for an averaging sample: every
    `purge_avg_stride`-th of the last `purge_avg` steps of the run (up to
    step `t`)."""
    total = int(keys.get("run_nstep", 0)) or 20001
    total += max(int(keys.get("research_output", 0)), 0)
    purge = int(keys.get("purge_avg", 0))
    window = min(purge, total) if purge > 0 else 0
    start = total - window + 1 if window else total + 1
    return range(start, (total if t is None else min(int(t), total)) + 1,
                 max(1, int(keys.get("purge_avg_stride", 1))))


# -- the wrappers around the program ----------------------------------------

@dataclass
class CaseRecord:
    enter: float
    exit: float
    solver_seconds: float
    prefix: str
    samples: int = 0                     # averaging samples counted


@dataclass
class Probe:
    """State shared by the wrappers (one per run)."""

    deadline: Optional[float] = None
    window: str = ""                     # the cell's window kind
    steps: int = 0
    samples: int = 0                     # averaging samples of the window
    case_samples: int = 0                # ... of the case in flight
    last_sample: int = 0                 # a case's last sample (its index + 1)
    need_sample: bool = False            # the window closes after a sample
    cases: List[CaseRecord] = field(default_factory=list)
    stash: dict = field(default_factory=dict)
    tracing: bool = False
    vk_timed: int = 0                    # inlet calls left to time (traced run)
    vk_skip: int = 0                     # ... and to pass first
    sync: Optional[object] = None        # waits for the card
    vk_host_s: List[float] = field(default_factory=list)
    trace_steps: int = 0
    on_steps: Optional[object] = None    # called before each runner call
    on_case_end: Optional[object] = None
    runner: Optional[object] = None      # the runner of the case in flight


def wrap_runner(run, probe: Probe):
    """The runner that `run_case` builds, counted and closable."""

    def runner(state, dyn, t0=0, n_steps=1):
        if probe.on_steps is not None:
            probe.on_steps()
        if probe.window == "steps" and probe.deadline is not None \
                and time.perf_counter() >= probe.deadline \
                and ("sample" in probe.stash or not probe.need_sample):
            probe.stash.update(run=run, state=state, t=int(t0))
            raise WindowClosed
        probe.steps += int(n_steps)
        if probe.tracing:
            probe.trace_steps += int(n_steps)
        return run(state, dyn, t0, n_steps)

    for attr in ("reset", "get_fbc", "set_fbc", "fields_stale"):
        setattr(runner, attr, getattr(run, attr))
    runner.inner = run
    return runner


def wrap_hook(hook, probe: Probe):
    """The inlet hook with its pure-DDF variant (its `kernel_spec` and
    `init_aux` kept) in a span while the stretch is traced, and timed on
    the host alone before it: after `probe.vk_skip` calls, `probe.vk_timed`
    calls, each after the card has run out of work, so that the time is
    the refresh's own enqueue, without the profiler and without waiting
    for a full launch queue."""
    inner = hook.ddf

    def ddf(fbc, t, aux=None):
        if probe.tracing:
            with span("vk_refresh", True):
                return inner(fbc, t, aux)
        if probe.vk_timed <= 0 or probe.deadline is None:
            return inner(fbc, t, aux)
        if probe.vk_skip > 0:
            probe.vk_skip -= 1
            return inner(fbc, t, aux)
        probe.sync()
        t0 = time.perf_counter()
        out = inner(fbc, t, aux)
        probe.vk_host_s.append(time.perf_counter() - t0)
        probe.vk_timed -= 1
        return out

    ddf.kernel_spec = inner.kernel_spec
    ddf.init_aux = inner.init_aux
    hook.ddf = ddf
    return hook


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def wrap_sample(real, probe: Probe, fused: bool):
    """The averaging pass as `run_case` reaches it (the fused pass or
    `welford_update`), counted; the window's last sample is kept for the
    check: its DDFs (and thermal DDFs), its weight, the benchmark's count of
    the samples before it, the accumulators before (copied to the host) and
    after.  In a window of steps that is the first sample after `--seconds`
    (the window closes at the next runner call, so its DDFs are the state
    the window leaves); in a window of cases, the last sample of a case,
    taken after `--seconds` (its DDFs copied too: a step follows)."""

    def sample(*a, **kw):
        fi, gi, avg = (a[0], None, a[4]) if fused else (a[1].fi, a[1].gi, a[0])
        k = probe.case_samples
        probe.samples += 1
        probe.case_samples += 1
        keep = (probe.deadline is not None and "sample" not in probe.stash
                and time.perf_counter() >= probe.deadline
                and (probe.window == "steps" or k + 1 == probe.last_sample))
        if not keep:
            return real(*a, **kw)
        before = tuple(_host_copy(v) for v in avg[1:] if v is not None)
        out = real(*a, **kw)
        if probe.window != "steps":
            fi, gi = _host_copy(fi), None if gi is None else _host_copy(gi)
        probe.stash["sample"] = dict(
            k=k, fi=fi, gi=gi, before=before, after=out, fused=fused,
            inv_n=float(a[3]) if fused else 1.0 / (avg.count + 1))
        return out

    return sample


@contextmanager
def instrumented(probe: Probe, *, capture=None):
    """The program's `make_runner` and averaging passes (as `run_case`
    reaches them), `run_case` (as every run mode reaches it) and
    `write_final_outputs` wrapped for this run.  With `capture`, `run_case`
    hands the case to `capture(case)` and raises `Captured` instead."""
    from latticeurbanwind_tpu_torch.run import driver, modes, standard

    # the run modes that bound `run_case` by name; not run/batch.py, whose
    # threads would share one Probe (a case-parallel cell brings a wrapper
    # of its own there)
    bound = (modes, standard)
    real_make, real_run, real_write = (driver.make_runner, driver.run_case,
                                       driver.write_final_outputs)
    real_avg, real_welford = driver.avg_update, driver.welford_update

    def make_runner(*a, **kw):
        run, impl = real_make(*a, **kw)
        wrapped = wrap_runner(run, probe)
        probe.runner = wrapped
        return wrapped, impl

    def run_case(case, **kw):
        if capture is not None:
            capture(case)
            raise Captured
        enter = time.perf_counter()
        probe.case_samples = 0
        with span("run_case", probe.tracing):
            res = real_run(case, **kw)
        done = time.perf_counter()
        runner, probe.runner = probe.runner, None
        rec = CaseRecord(enter=enter, exit=done,
                         solver_seconds=float(res.solver_seconds),
                         prefix=case.vtk_prefix, samples=probe.case_samples)
        probe.cases.append(rec)
        # a case that took another number of samples than the deck
        # asks for ends the window too: the check fails it
        ends = (probe.deadline is not None and done >= probe.deadline
                and ("sample" in probe.stash or not probe.need_sample
                     or rec.samples != probe.last_sample))
        if ends:
            probe.stash["ended"] = dict(case=case, result=res,
                                        runner=runner, samples=rec.samples)
        if probe.on_case_end is not None:
            probe.on_case_end()
        if ends and probe.window == "cases":
            raise WindowClosed
        return res

    def write_final_outputs(*a, **kw):
        with span("write_outputs", probe.tracing):
            return real_write(*a, **kw)

    driver.make_runner = make_runner
    for mod in bound:
        mod.run_case = run_case
    driver.write_final_outputs = write_final_outputs
    driver.avg_update = wrap_sample(real_avg, probe, True)
    driver.welford_update = wrap_sample(real_welford, probe, False)
    try:
        yield
    finally:
        driver.make_runner = real_make
        for mod in bound:
            mod.run_case = real_run
        driver.write_final_outputs = real_write
        driver.avg_update, driver.welford_update = real_avg, real_welford
        probe.runner = None


# -- one run ------------------------------------------------------------------

@dataclass
class Run:
    """What one run recorded: what the metric readers read."""

    cell: spec.Cell
    traced: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    grid_cells: int = 0
    cases_done: int = 0
    cases: List[CaseRecord] = field(default_factory=list)
    window_start: float = 0.0
    peak_bytes: int = 0
    work: Dict[str, float] = field(default_factory=dict)   # counts.work_of
    trace: Optional[Trace] = None
    trace_steps: int = 0
    samples: int = 0
    vk_host_s: List[float] = field(default_factory=list)
    devices: List[int] = field(default_factory=list)
    # host intervals spent starting and stopping the profiler (traced runs)
    pauses: List[tuple] = field(default_factory=list)
    setup_parts: Dict[str, float] = field(default_factory=dict)
    check_s: float = 0.0
    on_cuda: bool = True


def on(dev: torch.device):
    """The card `dev` as the current device (nothing for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def averaging_pass(case, shape, device):
    """(empty accumulators, `sample(state, avg) -> (state, avg)`): the
    averaging pass that `run_case` takes at each sample of `case`
    (run/driver.py): the fused pass (K-AVG), or, where the case is thermal
    or has probes (whose columns read the fields at every sample), the
    fields pass and Welford's step on accumulators with mean T where the
    case outputs T."""
    from latticeurbanwind_tpu_torch.lbm.fields import update_fields
    from latticeurbanwind_tpu_torch.lbm.state import dyn_row
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.run.welford import init_avg, welford_update

    if not case.config.thermal and not case.probes:
        row = dyn_row(case.dyn, device)

        def fused(st, avg):
            return st, avg_update(st.fi, st.flags, row, 1.0 / (avg.count + 1),
                                  avg, case.config)

        return init_avg(shape, False, device), fused

    def fields(st, avg):
        st = update_fields(st, case.config, case.dyn)
        return st, welford_update(avg, st)

    return init_avg(shape, case.thermal_output, device), fields


def warm_up(case, w: dict, devices: List[torch.device]) -> None:
    """A few dozen steps (and averaging samples) of the case on each card,
    through the program's runner and the case's averaging pass, writing
    nothing; the case's own DDFs (and thermal DDFs) are put back as they
    were."""
    from latticeurbanwind_tpu_torch.lbm.state import LBMState, to_device
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner

    st0 = case.state
    shape = tuple(st0.rho.shape)
    for dev in devices:
        with on(dev):
            if st0.fi.device == dev:
                keep = [(t, _host_copy(t)) for t in (st0.fi, st0.gi)
                        if t is not None]
                st = st0
            else:
                keep = []
                st = LBMState(*(to_device(a, dev) for a in st0))
            forcing = type(case.forcing)(*(to_device(v, dev) for v in case.forcing))
            run, _ = make_runner(case.config, forcing, shape=shape, device=dev,
                                 pre_step=case.pre_step)
            st = run(st, case.dyn, 0, int(w["steps"]))
            if w.get("samples"):
                avg, sample = averaging_pass(case, shape, dev)
                for _ in range(int(w["samples"])):
                    st, avg = sample(st, avg)
                del avg
            sync(dev)
            del run, st, forcing
            for t, saved in keep:
                t.copy_(saved)
            if keep:
                sync(dev)
    gc.collect()


class Watchdog:
    """Ends a run whose window goes wrong instead of letting it run on
    (a case of a million steps): a window of steps that has not reached
    the program's runner a few seconds in, and a window still open a
    minute after `--seconds`."""

    FIRST_S = 5.0
    LATE_S = 60.0

    def __init__(self, probe: Probe, kind: str, t_start: float, seconds: float):
        def at(s, fn):
            return threading.Timer(max(0.0, t_start + s - time.perf_counter()), fn)

        self.probe = probe
        self.fault: Optional[str] = None
        self.timers = [at(seconds + self.LATE_S, self._late)]
        if kind == "steps":
            self.timers.append(at(min(self.FIRST_S, seconds), self._first))

    def _end(self, why: str) -> None:
        self.fault = why
        _thread.interrupt_main()

    def _first(self) -> None:
        if self.probe.steps == 0:
            self._end("the window never reached the program's runner "
                      "(run/driver.py's make_runner)")

    def _late(self) -> None:
        if self.probe.deadline is not None:
            self._end(f"the window was still open {self.LATE_S:.0f} s after "
                      "--seconds (no runner call, or no averaging sample, "
                      "came after --seconds)")

    def __enter__(self):
        for t in self.timers:
            t.daemon = True
            t.start()
        return self

    def __exit__(self, typ, exc, tb):
        for t in self.timers:
            t.cancel()
        for t in self.timers:
            t.join()
        if self.fault is not None and (typ is None or typ is KeyboardInterrupt):
            raise RuntimeError(self.fault)
        return False


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
            t_process: float, work_dir: Path, device: str = "cuda",
            check_fn=None) -> tuple:
    """One run: set-up, window, check.  Returns (Run, check result)."""
    from latticeurbanwind_tpu_torch.run import modes

    os.environ.pop("LUW_PROGRESS_MODE", None)
    marks = [("start", t_process), ("imports", time.perf_counter())]
    w = cell.workload
    kind = w["window"]
    keys = deck_keys(cell, seed)
    run = Run(cell=cell, traced=traced)
    probe = Probe()
    cuda = torch.device(device).type == "cuda"
    ndev = cell.chips if cuda else 1
    devices = ([torch.device("cuda", i) for i in range(ndev)] if cuda
               else [torch.device("cpu")])
    run.devices = list(range(ndev))
    run.on_cuda = cuda
    tracer = Tracer(run.devices) if traced and cuda else None

    # set-up: the case built by the program, then the warm-up
    captured = {}
    deck = write_deck(cell, keys, work_dir, "case")
    with instrumented(probe, capture=lambda c: captured.setdefault("case", c)):
        try:
            modes.run_deck(deck, device=device, quiet=True, max_cases=1)
        except Captured:
            pass
    case = captured["case"]
    marks.append(("deck set-up", time.perf_counter()))
    shape = tuple(case.state.rho.shape)
    run.grid_cells = int(torch.tensor(shape).prod())
    if traced and case.pre_step is not None:
        wrap_hook(case.pre_step, probe)
        probe.vk_skip, probe.vk_timed = VK_SKIP, VK_TIMED
        probe.sync = lambda: sync(devices[0])
    warm_up(case, w["warmup"], devices)
    marks.append(("warm-up", time.perf_counter()))
    if tracer is not None:
        tracer.warm()
        marks.append(("profiler", time.perf_counter()))
    captured.clear()
    if kind != "steps":
        del case
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    for d in devices:
        sync(d)

    # the window
    tr = w.get("trace", {})
    state = {"tracing": False, "done": False}

    def trace_on():
        if tracer is not None and not state["tracing"] and not state["done"]:
            a = time.perf_counter()
            tracer.start()
            run.pauses.append((a, time.perf_counter()))
            probe.tracing = state["tracing"] = True

    def trace_off():
        if state["tracing"]:
            a = time.perf_counter()
            run.trace = tracer.stop()
            run.pauses.append((a, time.perf_counter()))
            probe.tracing = state["tracing"] = False
            state["done"] = True

    t_start = time.perf_counter()
    run.setup_s = t_start - t_process
    marks.append(("the rest", t_start))
    run.setup_parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    run.window_start = t_start
    probe.window = kind
    probe.need_sample = bool(w["check"]["samples"])
    probe.last_sample = len(sample_steps(keys))
    probe.deadline = t_start + seconds
    dog = Watchdog(probe, kind, t_start, seconds)
    if kind == "steps":
        def on_steps():
            now = time.perf_counter()
            if not state["tracing"] and now >= t_start + tr.get("from_s", 0):
                trace_on()
            elif state["tracing"] and now >= tracer.t0 + tr["seconds"]:
                trace_off()
        probe.on_steps = on_steps if tracer is not None else None
        with instrumented(probe), dog:
            try:
                modes.run_case(case, quiet=True)
                raise RuntimeError("the run ended before its window closed")
            except WindowClosed:
                pass
    elif kind == "cases":

        def on_case_end():
            n = len(probe.cases)
            if n == int(tr.get("case", 0)) - 1:
                trace_on()
            elif n == int(tr.get("case", 0)):
                trace_off()
        probe.on_case_end = on_case_end if tracer is not None else None
        with instrumented(probe), dog:
            try:
                with span("run_deck", probe.tracing):
                    modes.run_deck(deck, device=device, quiet=True)
                raise RuntimeError("the sweep ended before its window closed")
            except WindowClosed:
                pass
    else:
        raise ValueError(f"unknown window {kind!r}")
    trace_off()
    for d in devices:
        sync(d)
    t_end = time.perf_counter()
    run.window_s = t_end - t_start
    run.steps = probe.steps
    run.samples = probe.samples
    run.cases = list(probe.cases)
    run.cases_done = len(probe.cases)
    run.trace_steps = probe.trace_steps
    run.vk_host_s = list(probe.vk_host_s)
    if cuda:
        run.peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in devices)
    probe.deadline = None
    probe.on_steps = probe.on_case_end = None

    # the check, after the window has closed and the peak is read
    if kind == "steps":
        probe.stash.update(case=case, samples=probe.samples)
        del case
    t_check = time.perf_counter()
    result = check_fn(cell, run, probe.stash, keys, work_dir)
    run.check_s = time.perf_counter() - t_check
    probe.stash.clear()
    return run, result


def read_metrics(run: Run, names: List[str], units: Dict[str, str]) -> dict:
    out = {}
    for name in names:
        value = spec.reader(name, run.cell.root).read(run)
        if value is None:
            continue
        out[name] = {"value": float(value), "unit": units[name]}
    return out


def breakdown(run: Run) -> Optional[dict]:
    if run.trace is None:
        return None
    return {"device_ops": run.trace.top_device_ops(10),
            "idle_gaps": run.trace.idle_gaps(10)}


def device_info(run: Run) -> dict:
    info = {"platform": "gpu" if run.on_cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if run.on_cuda else "cpu",
            "count": len(run.devices), "memory_peak_bytes": int(run.peak_bytes)}
    if run.traced:
        info["busy_s"] = run.trace.mean_busy_s() if run.trace else 0.0
        info["window_s"] = run.trace.window_s if run.trace else 0.0
    return info


def result_line(run: Run, result, names: List[str], units: Dict[str, str]) -> dict:
    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed,
            "metrics": read_metrics(run, names, units),
            "device": device_info(run)}
    if run.traced:
        line["breakdown"] = breakdown(run)
    line["compared"] = result.compared
    return line


def new_work_dir() -> Path:
    return Path(tempfile.mkdtemp(prefix="luwbench-"))


def dumps(line: dict) -> str:
    return json.dumps(line, separators=(", ", ": "))
