"""Solver run driver: steps one case and writes its VTKs.

Counterpart of `latticeurbanwind_tpu/run/driver.py` (the reference's run_lbm
loop, setup.cpp:4117-4911), with the same event schedule and outputs:

  * stepping in chunks of at most `chunk` steps between events, after a
    16 + 16-step warm-up/calibration pair that feeds the timing plan;
  * Welford mean/variance accumulation over the final `purge_avg` window at
    `purge_avg_stride`, on the device; averaging-only events run the fused
    averaging pass (`ops.avg_kernel.avg_update`), events that also need the
    fields run `update_fields` + `welford_update`;
  * unsteady raw u VTKs every `unsteady_output` steps;
  * finalize: raw u/rho VTKs and `<prefix><datetime>_avg-<t>.vtk` with
    u_avg/rho_avg/fluid + tke/TI/TLS, and transform.info.

Not ported: the device mesh, checkpoints and video frames each raise when
a case asks for them; probes have no field here (profile decks set none);
PNG snapshots are left out with one printed line.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.progress import ProgressEmitter
from ..io.vtk import write_structured_points
from ..lbm.fields import update_fields
from ..lbm.state import DynParams, Forcing, LBMState, StepConfig, dyn_row
from ..lbm.stepper import make_runner
from ..ops.avg_kernel import avg_update
from ..units import Units
from .derived import derived_turbulence_fields
from .info import RunInfo
from .welford import AvgState, init_avg, variance_sum_u, welford_update

DEFAULT_RUN_STEPS = 20001


def vtk_timestep_name(name: str, t: int) -> str:
    """`<name>-<9-digit t>.vtk` (reference default_filename, lbm.cpp:235)."""
    return f"{name}-{t:09d}.vtk"


@dataclass
class RunSettings:
    run_nstep: int = 0                 # 0 -> default 20001
    research_output: int = 0
    unsteady_output: int = 0
    purge_avg: int = 0
    purge_avg_stride: int = 1
    output_fields: Tuple[str, ...] = ("tke", "ti", "tls")
    chunk: int = 50                    # max steps between host checks
    checkpoint_interval: int = 0       # not ported: must stay 0
    snapshots: bool = True             # PNG snapshots: not ported, announced
    frame_output: int = 0              # not ported: must stay 0


@dataclass
class SolverCase:
    """Everything needed to run one LBM case on one device."""

    config: StepConfig
    forcing: Forcing
    state: LBMState
    dyn: DynParams
    units: Units
    cell_m: float
    parent: Path
    datetime: str
    vtk_prefix: str = ""
    nz_out: int = 0                    # crop output above this (sponge rows)
    settings: RunSettings = field(default_factory=RunSettings)
    origin_shift: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ngpu: Tuple[int, int, int] = (1, 1, 1)


@dataclass
class RunResult:
    state: Optional[LBMState]
    avg: Optional[AvgState]
    total_steps: int
    solver_seconds: float
    files: List[Path]
    timing: Dict[str, float]

    def release_device_state(self) -> None:
        """Drop the final state and accumulators so a batch frees device
        memory before building its next case."""
        self.state = None
        self.avg = None


def _sync(state: LBMState) -> None:
    if state.fi.device.type == "cuda":
        torch.cuda.synchronize(state.fi.device)


def _check_supported(case: SolverCase) -> None:
    s = case.settings
    if int(np.prod(case.ngpu)) > 1:
        raise NotImplementedError(
            f"n_gpu={list(case.ngpu)}: multi-GPU runs are not ported yet "
            "(ROADMAP module item 11)")
    if s.checkpoint_interval > 0:
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP module item 9)")
    if s.frame_output > 0:
        raise NotImplementedError(
            "video frames are not ported yet (ROADMAP module item 10)")
    if case.config.thermal:
        raise NotImplementedError(
            "thermal runs are not ported yet (ROADMAP module item 8)")


def run_case(case: SolverCase, *, quiet: bool = False) -> RunResult:
    _check_supported(case)
    s = case.settings
    total_steps = (s.run_nstep if s.run_nstep > 0 else DEFAULT_RUN_STEPS) + max(s.research_output, 0)
    avg_window = min(s.purge_avg, total_steps) if s.purge_avg > 0 else 0
    avg_stride = max(1, s.purge_avg_stride)
    avg_start = total_steps - avg_window + 1 if avg_window else total_steps + 1
    unsteady = max(0, s.unsteady_output)

    state = case.state
    device = state.fi.device
    shape = tuple(state.rho.shape)
    progress = ProgressEmitter("solve")
    files: List[Path] = []

    advance, impl_name = make_runner(case.config, case.forcing, shape=shape,
                                     device=device)
    if unsteady and s.snapshots and not quiet:
        print("| Snapshots       | PNG snapshots are not written by the "
              "PyTorch port (ROADMAP module item 10)")

    def refresh(st: LBMState) -> LBMState:
        return update_fields(st, case.config, case.dyn)

    events = set()
    if unsteady:
        events.update(range(unsteady, total_steps + 1, unsteady))
    if avg_window:
        events.update(range(avg_start, total_steps + 1, avg_stride))
    events.add(total_steps)
    event_list = sorted(events)

    avg = init_avg(shape, False, device) if avg_window else None
    avg_samples = 0
    dyn_dev = dyn_row(case.dyn, device)

    u_factor = case.units.si_u(1.0)
    vtk_dir = case.parent / "RESULTS" / "vtk"
    raw_base = f"{case.vtk_prefix}{case.datetime}_raw_"

    def write_raw(name: str, data: np.ndarray, t: int):
        path = vtk_dir / vtk_timestep_name(raw_base + name, t)
        write_structured_points(
            path, {"data": np.asarray(data).astype(np.float32)},
            spacing=case.cell_m, origin_shift=case.origin_shift,
            nz_write=case.nz_out,
        )
        files.append(path)

    info = RunInfo(total_steps=total_steps,
                   avg_start=avg_start if avg_window else 0,
                   n_cells=int(np.prod(shape)),
                   storage=case.config.storage,
                   thermal=case.config.thermal)

    t = 0
    t0 = time.perf_counter()
    avail = (event_list[0] if event_list else total_steps) - t
    bench_steps = min(16, avail // 2, total_steps)
    info.start(t)
    calibrated = False
    if bench_steps > 0:
        # the first batch warms up (kernel build + load) so the second times
        # pure stepping, like the reference's 16-step benchmark
        # (setup.cpp:4799-4841)
        state = advance(state, case.dyn, t, bench_steps)
        _sync(state)
        t += bench_steps
        info.start(t)
        state = advance(state, case.dyn, t, bench_steps)
        _sync(state)
        t += bench_steps
        info.update(t)
        calibrated = True
    timing = {"normal_steps_per_second": info.steps_per_second()}
    if not quiet and calibrated:
        print(info.timing_plan(impl_name)
              + f", ETA {info.eta_seconds(t):.1f} s")
    progress.emit("Solving CFD", f"{t}/{total_steps} steps", t, total_steps)

    avg_phase_t0 = None
    avg_phase_start_t = 0
    last_unsteady_t = -1

    for ev in event_list:
        while t < ev:
            n = min(s.chunk, ev - t)
            state = advance(state, case.dyn, t, n)
            t += n
            if not quiet and progress.enabled:
                _sync(state)
                info.update(t)
                progress.emit(
                    "Solving CFD",
                    f"{t}/{total_steps} steps | "
                    f"{info.steps_per_second():.1f} Steps/s | "
                    f"ETA {info.eta_seconds(t):.0f} s",
                    t, total_steps)
        # materialize the fields once if anything field-consuming fires
        # here; averaging-only events run the fused averaging pass
        fires_avg = (avg_window and t >= avg_start
                     and (t - avg_start) % avg_stride == 0)
        wants_fields = (
            (unsteady and t % unsteady == 0 and t > 0 and t != last_unsteady_t)
            or t == total_steps)
        if wants_fields:
            state = refresh(state)
        if fires_avg:
            if avg_phase_t0 is None:
                _sync(state)
                avg_phase_t0 = time.perf_counter()
                avg_phase_start_t = t
            if not wants_fields:
                avg = avg_update(state.fi, state.flags, dyn_dev,
                                 1.0 / float(avg_samples + 1), avg, case.config)
            else:
                avg = welford_update(avg, state)
            avg_samples += 1
        if unsteady and t % unsteady == 0 and t > 0 and t != last_unsteady_t:
            write_raw("u", state.u.cpu().numpy() * u_factor, t)
            last_unsteady_t = t

    _sync(state)
    solver_seconds = time.perf_counter() - t0
    if avg_phase_t0 is not None and t > avg_phase_start_t:
        timing["avg_steps_per_second"] = (t - avg_phase_start_t) / max(
            time.perf_counter() - avg_phase_t0, 1e-9)
    timing["solver_seconds"] = solver_seconds
    timing["mlups"] = info.mlups()

    write_final_outputs(case, state, avg, avg_samples, t, files,
                        skip_raw_u=(last_unsteady_t == t))

    progress.done("Solving CFD", f"{t}/{total_steps} steps")
    return RunResult(state=state, avg=avg, total_steps=t,
                     solver_seconds=solver_seconds, files=files, timing=timing)


def write_final_outputs(case: SolverCase, state: LBMState,
                        avg: Optional[AvgState], avg_samples: int, t: int,
                        files: List[Path], *, skip_raw_u: bool = False,
                        ) -> List[Path]:
    """Finalize one case: transient u/rho VTKs, the `_avg` VTK with
    u_avg/rho_avg/fluid + the requested tke/TI/TLS, and transform.info
    (reference setup.cpp:4718-4798, 2513-2683).  File names and fields are
    the JAX package's."""
    s = case.settings
    u_factor = case.units.si_u(1.0)
    rho_factor = case.units.si_rho(1.0)
    dt_si = case.units.si_t(1)
    vtk_dir = case.parent / "RESULTS" / "vtk"
    raw_base = f"{case.vtk_prefix}{case.datetime}_raw_"

    def write_raw(name: str, data: np.ndarray):
        path = vtk_dir / vtk_timestep_name(raw_base + name, t)
        write_structured_points(
            path, {"data": np.asarray(data).astype(np.float32)},
            spacing=case.cell_m, origin_shift=case.origin_shift,
            nz_write=case.nz_out)
        files.append(path)

    if not skip_raw_u:
        write_raw("u", state.u.cpu().numpy() * u_factor)
    write_raw("rho", state.rho.cpu().numpy() * rho_factor)

    if avg is not None and avg_samples > 0:
        mean_u = avg.mean_u.cpu().numpy()
        var_sum = variance_sum_u(avg).cpu().numpy()
        flags = state.flags.cpu().numpy()
        fields: Dict[str, np.ndarray] = {
            "u_avg": (mean_u * u_factor).astype(np.float32),
            "rho_avg": (avg.mean_rho.cpu().numpy() * rho_factor).astype(np.float32),
        }
        want = tuple(f.lower() for f in s.output_fields)
        derived = derived_turbulence_fields(
            mean_u, var_sum, flags, avg_count=avg_samples,
            u_factor=u_factor, spacing=case.cell_m, want=want)
        fields["fluid"] = derived.pop("fluid")
        for key in ("tke", "TI", "TLS"):
            if key in derived and key.lower() in want:
                fields[key] = derived[key]
        avg_path = vtk_dir / vtk_timestep_name(
            f"{case.vtk_prefix}{case.datetime}_avg", t)
        write_structured_points(avg_path, fields, spacing=case.cell_m,
                                origin_shift=case.origin_shift, nz_write=case.nz_out)
        files.append(avg_path)

    if s.research_output > 0:
        info_path = case.parent / "proj_temp" / "transform.info"
        info_path.parent.mkdir(parents=True, exist_ok=True)
        info_path.write_text(f"dt = {dt_si:.10f}s\n")
        files.append(info_path)
    return files
