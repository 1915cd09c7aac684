"""Case-parallel batch execution: one case per card.

Counterpart of `latticeurbanwind_tpu/run/batch.py`.  The reference runs its
.luwdg / .luwpf batches strictly serially, a new LBM instance per (inflow,
angle) case on the same GPUs (setup.cpp:5690-5753, 5997-6145).  The cases of
a sweep are independent, so with several cards each card holds one case's
whole lattice and steps it with the single-card kernels, with no traffic
between cards.

`run_cases_case_parallel` groups the cases into batches of D = min(cards,
cases); each case of a batch runs the serial driver's own `run_case` in a
thread of its own, on its own card (`cuda:i`), and the batch ends when
every thread has.  A case-parallel case therefore equals its serial run
code for code (the JAX package's shard_map loop holds its cases to the
serial run within rtol 2e-4), with the serial run's files.  With one card
D = 1 and the cases run in turn.

The JAX package's eligibility rule is kept (`case_parallel_unsupported`):
cases with probes, unsteady/frame/checkpoint events, a VK inlet pre-step
or thermal physics go to the serial driver (`run/modes.py`).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..lbm.state import Forcing, LBMState, to_device
from .driver import DEFAULT_RUN_STEPS, RunResult, SolverCase, run_case

__all__ = ["case_devices", "case_parallel_unsupported",
           "run_cases_case_parallel"]


def case_parallel_unsupported(cases: Sequence[SolverCase]) -> Optional[str]:
    """Why this batch cannot run case-parallel (None = it can); the JAX
    package's reasons, in its order."""
    if len(cases) < 2:
        return "fewer than two cases"
    c0 = cases[0]
    if c0.config.thermal:
        return "thermal cases need the serial event loop"
    for c in cases:
        if c.probes:
            return "probe sampling needs the serial event loop"
        if c.pre_step is not None:
            return "VK inlet pre-step needs the serial event loop"
        s = c.settings
        total = (s.run_nstep if s.run_nstep > 0 else DEFAULT_RUN_STEPS) \
            + max(s.research_output, 0)
        fires = [v for v in (s.unsteady_output, s.frame_output,
                             s.checkpoint_interval) if 0 < v <= total]
        if fires:
            return "unsteady/frame/checkpoint events need the serial driver"
        if c.config != c0.config:
            return "cases differ in StepConfig (storage/omega/...)"
        if tuple(c.state.rho.shape) != tuple(c0.state.rho.shape):
            return "cases differ in grid shape"
        if (c.forcing.nudge_sigma is None) != (c0.forcing.nudge_sigma is None) \
                or (c.forcing.sponge_sigma_z is None) != (c0.forcing.sponge_sigma_z is None):
            return "cases differ in forcing structure"
        if int(np.prod(c.ngpu)) > 1:
            return "n_gpu spatial split requested (use one chip per case)"
        # the JAX batch applies case 0's dyn to every case; the rule stays
        if (c.dyn is None) != (c0.dyn is None) or (
                c.dyn is not None and not (
                    torch.equal(torch.as_tensor(c.dyn.force).cpu(),
                                torch.as_tensor(c0.dyn.force).cpu())
                    and torch.equal(torch.as_tensor(c.dyn.omega_coriolis).cpu(),
                                    torch.as_tensor(c0.dyn.omega_coriolis).cpu()))):
            return "cases differ in dynamic parameters (force/Coriolis)"
    return None


def case_devices(device: torch.device | str) -> List[torch.device]:
    """The devices a batch spreads over: every visible card for "cuda"
    (no index), else the one device named."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _placed(case: SolverCase, dev: torch.device) -> SolverCase:
    """The case with its state and forcing on `dev` (exact copies)."""
    return replace(case, device=dev,
                   state=LBMState(*(to_device(a, dev) for a in case.state)),
                   forcing=Forcing(*(to_device(v, dev) for v in case.forcing)))


def _run_on(case: SolverCase, dev: torch.device) -> RunResult:
    """The serial driver on `dev`, in the calling thread; the case's own
    state is dropped once it has run."""
    with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
        result = run_case(_placed(case, dev), quiet=True)
    case.state = None
    return result


def run_cases_case_parallel(cases: Sequence[SolverCase], *,
                            devices: Optional[Sequence[torch.device]] = None,
                            quiet: bool = False) -> List[RunResult]:
    """Run the cases one per device, in batches of min(devices, cases).
    `devices` defaults to `case_devices` of the first case's device; any
    case's exception is raised here.  Only the last case keeps its final
    state (`RunResult.release_device_state`), as in a serial batch."""
    reason = case_parallel_unsupported(cases)
    if reason:
        raise ValueError(f"case-parallel unsupported: {reason}")
    c0 = cases[0]
    if devices is None:
        devices = case_devices(c0.device if c0.device is not None
                               else c0.state.fi.device)
    devices = [torch.device(d) for d in devices]
    s = c0.settings
    shape = tuple(c0.state.rho.shape)
    total_steps = (s.run_nstep if s.run_nstep > 0 else DEFAULT_RUN_STEPS) \
        + max(s.research_output, 0)
    avg_window = min(s.purge_avg, total_steps) if s.purge_avg > 0 else 0
    avg_stride = max(1, s.purge_avg_stride)
    D = min(len(devices), len(cases))
    tier = "cuda" if devices[0].type == "cuda" else "plain"
    if not quiet:
        print(f"| Case-parallel   | {len(cases)} cases over {D} device(s), "
              f"tier={tier}, {total_steps} steps "
              f"(avg window {avg_window} @ stride {avg_stride})")

    results: List[RunResult] = []
    with ThreadPoolExecutor(max_workers=D) as pool:
        for b0 in range(0, len(cases), D):
            batch = list(cases[b0:b0 + D])
            for r in results:        # free the finished cases' devices
                r.release_device_state()
            t0 = time.perf_counter()
            futures = [pool.submit(_run_on, c, devices[j])
                       for j, c in enumerate(batch)]
            done = [f.result() for f in futures]
            secs = time.perf_counter() - t0
            if not quiet:
                mlups = (np.prod(shape) * total_steps * len(batch)
                         / max(secs, 1e-9) / 1e6)
                note = " incl. kernel build" if b0 == 0 else ""
                print(f"| Case-parallel   | batch of {len(batch)}: "
                      f"{secs:.1f} s total ({mlups:.0f} MLUPs aggregate{note})")
            for r in done:
                r.timing["case_parallel_batch"] = float(len(batch))
            results.extend(done)
    for r in results[:-1]:
        r.release_device_state()
    return results
