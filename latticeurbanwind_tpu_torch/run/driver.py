"""Solver run driver: steps one case and writes its VTKs.

Counterpart of `latticeurbanwind_tpu/run/driver.py` (the reference's run_lbm
loop, setup.cpp:4117-4911), with the same event schedule and outputs:

  * stepping in chunks of at most `chunk` steps between events, after a
    16 + 16-step warm-up/calibration pair that feeds the timing plan;
  * Welford mean/variance accumulation over the final `purge_avg` window at
    `purge_avg_stride`, on the device; averaging-only events run the fused
    averaging pass (`ops.avg_kernel.avg_update`), events that also need the
    fields run `update_fields` + `welford_update`; a thermal run takes the
    second route at every sample (the fused pass is non-thermal, as in the
    JAX package) and accumulates `mean_T` too;
  * probe columns sampled over the averaging window at the averaging
    stride, all columns in one device-to-host readback per sample;
  * unsteady raw u VTKs every `unsteady_output` steps, each with a PNG
    snapshot and its 3-D companion (`run/snapshots.py`,
    `proj_temp/snapshots/<prefix><datetime>_<t:09d>[_3d].png`), and a
    perspective video frame every `frame_output` steps
    (`proj_temp/frames/<prefix><datetime>_<t // frame_output:06d>.png`);
    both render on the fields' CUDA device, a split run's from its fields
    gathered to the host;
  * a checkpoint every `checkpoint_interval` steps
    (`proj_temp/checkpoints/<prefix><datetime>.ckpt.npz`, `run/checkpoint.py`)
    with the fields refreshed first; with `resume` an existing checkpoint
    is loaded, the run goes on from its step (no calibration pair, no event
    at or before it) with the saved accumulators, probe buffers and face
    targets, and the VK hook's carried anchors follow from the step;
  * finalize: raw u/rho[/T] VTKs and `<prefix><datetime>_avg-<t>.vtk` with
    u_avg/rho_avg[/T_avg]/fluid + tke/TI/TLS (temperatures through the
    affine map back to Kelvin), the probe CSVs, and transform.info.

A case whose `ngpu` = [Dx, Dy, Dz] asks for more than one device runs split
over a mesh (`parallel/`; the JAX package's `run_case` :169-231) under the
device rule of `parallel/mesh.py::domain_mesh`: "cuda" puts shard i on card
i, and with fewer cards than shards runs on one card and prints the JAX
package's line; "cuda:k" puts every shard on card k; "cpu" every shard on
the CPU.  Each step is then one K8 launch per shard (`parallel/halo.py`);
the fields pass and the Welford accumulators run per shard and the fused
averaging pass is not taken (JAX `run_case` :346); probes read their columns
from the shards that own them; outputs gather the fields to the host.
MLUPs count the grid's cells, not the ghosts.  A split that does not divide
the grid gives shards whose sizes differ by one cell (`DomainMesh.edges`,
numpy.array_split's cuts).  A checkpoint of a split run holds one block per
shard and resumes under any split or none.

Several processes (`parallel/comm.py::ensure_distributed`; JAX
`run_case` :189 and `parallel/mesh.py:56-72`): every process runs this loop
with the same events for the shards it holds.  The fields, the probe
columns and the accumulators gather to process 0, which alone writes the
raw and averaged VTKs, snapshots, frames, probe CSVs and transform.info (the
JAX `run_case` cannot: its `np.asarray` of a field that spans processes
fails, :452, :515-529); a checkpoint is written by every process as one set
(`run/checkpoint.py`).  Every process loads the set itself, and the run
raises before its first step when they disagree on the resume point.  The
calibration batch and the solver's clock are framed by barriers.
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
from ..lbm.state import (
    DynParams, Forcing, LBMState, StepConfig, dyn_row, to_device,
)
from ..lbm.stepper import make_runner
from ..ops.avg_kernel import avg_update
from ..ops.stream_collide import FaceBC
from ..parallel.comm import all_gather_object, barrier
from ..parallel.halo import make_sharded_runner, update_fields_sharded
from ..parallel.mesh import (
    DomainMesh, ShardedState, column_reader, domain_mesh, gather_state,
    gather_tensors, shard_state, shard_tensor, sync,
)
from ..units import Units
from .checkpoint import checkpoint_path, load_checkpoint, load_fbc, save_checkpoint
from .derived import derived_turbulence_fields
from .info import RunInfo
from .probes import GridProbe
from .sizing import effective_ngpu
from .snapshots import write_frame, write_snapshot
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
    checkpoint_interval: int = 0       # save state every N steps (0 = off)
    resume: bool = True                # resume from an existing checkpoint
    snapshots: bool = True             # render PNG snapshots at unsteady events
    frame_output: int = 0              # perspective video frame every N steps


@dataclass
class SolverCase:
    """Everything needed to run one LBM case on one device."""

    config: StepConfig
    forcing: Forcing
    # the whole domain's initial state; a run split over a mesh takes it
    # from the case (sets None) once it is sharded
    state: Optional[LBMState]
    dyn: DynParams
    units: Units
    cell_m: float
    parent: Path
    datetime: str
    vtk_prefix: str = ""
    nz_out: int = 0                    # crop output above this (sponge rows)
    settings: RunSettings = field(default_factory=RunSettings)
    probes: List[GridProbe] = field(default_factory=list)
    thermal_output: bool = False       # include T in outputs/averaging
    origin_shift: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ngpu: Tuple[int, int, int] = (1, 1, 1)
    pre_step: Optional[object] = None  # callable (state, t) -> state (VK inlet)
    # the device the run asked for (the device rule of parallel/mesh.py):
    # None is the state's own device
    device: Optional[torch.device] = None


@dataclass
class RunResult:
    """One case's run.  Over several processes `state` and `avg` are the
    gathered whole-domain arrays in process 0 and None in the others, whose
    `files` is empty (they write only their checkpoint files)."""

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


def _sync(state) -> None:
    """Wait for the device of a state, or for every shard's device."""
    if isinstance(state, ShardedState):
        sync(state.mesh.local_devices)
    else:
        sync([state.fi.device])


def _gather_avg(avgs: Tuple[AvgState, ...], mesh: DomainMesh) -> AvgState:
    """The whole domain's accumulators on the host from the shards' ones
    (None for another process's shard), their ghosts stripped: in process
    0; None in the others."""
    first = avgs[mesh.local[0]]

    def part(k):
        if getattr(first, k) is None:
            return None
        return gather_tensors([None if a is None else getattr(a, k)
                               for a in avgs], mesh)

    fields = [part(k) for k in AvgState._fields[1:]]
    return AvgState(first.count, *fields) if mesh.rank == 0 else None


def run_case(case: SolverCase, *, quiet: bool = False) -> RunResult:
    s = case.settings
    total_steps = (s.run_nstep if s.run_nstep > 0 else DEFAULT_RUN_STEPS) + max(s.research_output, 0)
    avg_window = min(s.purge_avg, total_steps) if s.purge_avg > 0 else 0
    avg_stride = max(1, s.purge_avg_stride)
    avg_start = total_steps - avg_window + 1 if avg_window else total_steps + 1
    unsteady = max(0, s.unsteady_output)
    frames = max(0, s.frame_output)
    probe_window = avg_window if case.probes else 0
    probe_start = total_steps - probe_window + 1 if probe_window else total_steps + 1

    state = case.state
    device = state.fi.device
    shape = tuple(state.rho.shape)
    progress = ProgressEmitter("solve")
    files: List[Path] = []

    spent = {"checkpoint_load": 0.0, "checkpoint_save": 0.0,
             "snapshot": 0.0, "frame": 0.0}
    avg_samples = 0
    resume_t = 0
    avg_loaded = fbc_saved = None
    ckpt_path = None
    if s.checkpoint_interval > 0:
        ckpt_path = checkpoint_path(case.parent, case.datetime, case.vtk_prefix)
        if s.resume and ckpt_path.exists():
            t_load = time.perf_counter()
            try:
                # host tensors: placed below on the run's device or split
                # over its mesh, whatever mesh they were saved under
                loaded, resume_t, avg_loaded, avg_samples, _ = load_checkpoint(
                    ckpt_path, expect_shape=shape, probes=case.probes)
                fbc_saved = load_fbc(ckpt_path)
                state = loaded
            except (ValueError, KeyError, OSError) as e:
                print(f"| Checkpoint      | ignoring unreadable checkpoint: {e}")
                resume_t = avg_samples = 0
                avg_loaded = fbc_saved = None
            spent["checkpoint_load"] = time.perf_counter() - t_load

    asked = case.device if case.device is not None else device
    split = effective_ngpu(case.ngpu, asked)
    mesh = None
    if int(np.prod(split)) > 1:
        mesh = domain_mesh(split, shape, asked)
        if mesh.processes > 1:
            # each process read the checkpoint itself: one that resumed
            # elsewhere would post other steps' halos and hang the others
            points = all_gather_object((resume_t, avg_samples,
                                        fbc_saved is not None))
            if len(set(points)) > 1:
                raise RuntimeError(
                    "the processes disagree on the resume point (step, "
                    f"samples, face targets) by process: {points}")
        # the face targets from the whole domain's fields, then the domain
        # is held once, in its shards
        advance, impl_name = make_sharded_runner(
            case.config, case.forcing, mesh, pre_step=case.pre_step,
            init_u=state.u, init_T=state.T)
        state = shard_state(state, mesh)
        case.state = None
        if not quiet:
            shapes = dict.fromkeys(mesh.local_shape(i) for i in range(mesh.n))
            where = sorted({str(d) for d in mesh.local_devices})
            if mesh.processes > 1:
                where = (f"{where} in process {mesh.rank} of "
                         f"{mesh.processes} (shards {list(mesh.local)}; data "
                         f"over {mesh.transport.backend})")
            print(f"| Device mesh     | n_gpu={list(case.ngpu)} -> {mesh.n} "
                  f"shards of {' / '.join(map(str, shapes))} (Z, Y, X with "
                  f"ghosts) on {where}")
    else:
        if int(np.prod(case.ngpu)) > 1 and not quiet:
            print(f"| Device mesh     | n_gpu={list(case.ngpu)} requested, "
                  f"{torch.cuda.device_count()} device(s) visible — "
                  "single-device run")
        if resume_t:
            state = LBMState(*(to_device(a, device) for a in state))
        advance, impl_name = make_runner(case.config, case.forcing,
                                         shape=shape, device=device,
                                         pre_step=case.pre_step)
    if fbc_saved is not None:
        # the carried nudge/sponge face targets, so a VK run continues
        # bit-exactly; a JAX checkpoint of a split run holds them padded
        # with the JAX runner's ghosts, which this runner refuses: they then
        # refresh at the next VK anchor, as in the JAX package after a
        # change of mesh
        home = mesh.devices[0] if mesh is not None else device
        try:
            advance.set_fbc(FaceBC(*(to_device(v, home) for v in fbc_saved)))
        except ValueError as e:
            print("| Checkpoint      | face targets not restored "
                  f"({e}); they refresh at the next VK anchor")
    if resume_t and not quiet:
        print(f"| Checkpoint      | resumed from step {resume_t}")

    def refresh(st):
        if mesh is not None:
            return update_fields_sharded(st, case.config, case.dyn)
        return update_fields(st, case.config, case.dyn)

    # this process writes the outputs: the only one, or process 0
    writes = mesh is None or mesh.rank == 0

    def gathered(st, name: str):
        return gather_tensors([None if sh is None else getattr(sh, name)
                               for sh in st.shards], mesh)

    def host_u(st) -> Optional[torch.Tensor]:
        if mesh is None:
            return st.u.cpu()
        return gathered(st, "u")

    def render(writer, path: Path, **kw) -> Optional[Path]:
        """`writer` on what the renderers read: the current state, or a
        split run's u and flags gathered to the host (in every process;
        the one that writes renders)."""
        if mesh is None:
            return writer(state, path, **kw)
        view = LBMState(fi=None, rho=None, u=host_u(state),
                        flags=gathered(state, "flags"))
        return writer(view, path, **kw) if writes else None

    def timed(kind: str, fn):
        """fn()'s result, its host seconds (after the queued steps) added
        to `spent[kind]`."""
        _sync(state)
        t_ev = time.perf_counter()
        out = fn()
        spent[kind] += time.perf_counter() - t_ev
        return out

    events = set()
    if unsteady:
        events.update(range(unsteady, total_steps + 1, unsteady))
    if frames:
        events.update(range(frames, total_steps + 1, frames))
    if avg_window:
        events.update(range(avg_start, total_steps + 1, avg_stride))
    if probe_window:
        events.update(range(probe_start, total_steps + 1, avg_stride))
    if ckpt_path is not None:
        events.update(range(s.checkpoint_interval, total_steps + 1,
                            s.checkpoint_interval))
    events.add(total_steps)
    event_list = sorted(events)

    # under a mesh: one AvgState per shard, ghosts included (None for
    # another process's shard)
    avg = None
    if avg_loaded is not None:
        if mesh is not None:
            avg = tuple(AvgState(avg_loaded.count, *(
                None if v is None else shard_tensor(v, mesh, i)
                for v in avg_loaded[1:])) if mesh.is_local(i) else None
                for i in range(mesh.n))
        else:
            avg = AvgState(avg_loaded.count, *(
                to_device(v, device) for v in avg_loaded[1:]))
    elif avg_window:
        avg = (tuple(None if sh is None else
                     init_avg(tuple(sh.rho.shape), case.thermal_output,
                              sh.rho.device) for sh in state.shards)
               if mesh is not None
               else init_avg(shape, case.thermal_output, device))
    dyn_dev = dyn_row(case.dyn, device)
    # the fused averaging pass is non-thermal: a thermal run refreshes the
    # fields at every sample, and so does a sharded one (no K-AVG under a
    # mesh, as in the JAX package's run_case)
    avg_fused = not case.config.thermal and mesh is None
    read_columns = None                              # state -> (3, Z, P)
    if case.probes:
        ys, xs = [p.y for p in case.probes], [p.x for p in case.probes]
        if mesh is not None:
            read_columns = column_reader(mesh, ys, xs)
        else:
            yx = (torch.tensor(ys, device=device), torch.tensor(xs, device=device))
            read_columns = lambda st: st.u[:, :, yx[0], yx[1]].cpu().numpy()

    u_factor = case.units.si_u(1.0)
    dt_si = case.units.si_t(1)
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

    t = resume_t
    barrier()           # the solver's clock starts and stops in every process
    t0 = time.perf_counter()
    next_events = [e for e in event_list if e > t]
    avail = (next_events[0] if next_events else total_steps) - t
    bench_steps = 0 if t else min(16, avail // 2, total_steps)
    info.start(t)
    calibrated = False
    if bench_steps > 0:
        # the first batch warms up (kernel build + load) so the second times
        # pure stepping, like the reference's 16-step benchmark
        # (setup.cpp:4799-4841)
        state = advance(state, case.dyn, t, bench_steps)
        _sync(state)
        barrier()
        t += bench_steps
        info.start(t)
        state = advance(state, case.dyn, t, bench_steps)
        _sync(state)
        barrier()
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
        if ev <= resume_t:
            continue   # handled before the interruption
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
        fires_probe = bool(case.probes and t >= probe_start
                           and (t - probe_start) % avg_stride == 0)
        fires_unsteady = bool(unsteady and t % unsteady == 0 and t > 0
                              and t != last_unsteady_t)
        fires_frame = bool(frames and t % frames == 0 and t > 0)
        fires_ckpt = bool(ckpt_path is not None
                          and t % s.checkpoint_interval == 0 and t > resume_t)
        wants_fields = (
            fires_probe or fires_unsteady or fires_frame or fires_ckpt
            or t == total_steps
            or (fires_avg and not avg_fused))
        if wants_fields:
            state = refresh(state)
        if fires_avg:
            if avg_phase_t0 is None:
                _sync(state)
                avg_phase_t0 = time.perf_counter()
                avg_phase_start_t = t
            if avg_fused and not wants_fields:
                avg = avg_update(state.fi, state.flags, dyn_dev,
                                 1.0 / float(avg_samples + 1), avg, case.config)
            elif mesh is not None:
                avg = tuple(None if sh is None else welford_update(a, sh)
                            for a, sh in zip(avg, state.shards))
            else:
                avg = welford_update(avg, state)
            avg_samples += 1
        if fires_probe:
            cols = read_columns(state)
            for pi, p in enumerate(case.probes if writes else ()):
                p.sample_column(cols[:, :, pi], t * dt_si, u_factor)
        title = f"{case.vtk_prefix}{case.datetime} step {t}"
        if fires_frame:
            # per-event video frame (reference setup.cpp:4843-4861): PNG
            # only, ffmpeg-ready numbering, perspective camera
            frame = case.parent / "proj_temp" / "frames" / (
                f"{case.vtk_prefix}{case.datetime}_{t // frames:06d}.png")
            made = timed("frame", lambda: render(
                write_frame, frame, nz_out=case.nz_out, title=title))
            if writes:
                files.append(made)
        if fires_unsteady:
            u_now = host_u(state)
            if writes:
                write_raw("u", u_now.numpy() * u_factor, t)
            last_unsteady_t = t
            if s.snapshots:
                snap = case.parent / "proj_temp" / "snapshots" / (
                    f"{case.vtk_prefix}{case.datetime}_{t:09d}.png")
                made = timed("snapshot", lambda: render(
                    write_snapshot, snap, u_factor=u_factor,
                    nz_out=case.nz_out, title=title))
                if writes:
                    files.append(made)
        if fires_ckpt:
            timed("checkpoint_save", lambda: save_checkpoint(
                ckpt_path, state, step=t, avg=avg, avg_samples=avg_samples,
                probes=case.probes, meta={"total_steps": total_steps},
                fbc=advance.get_fbc()))

    _sync(state)
    barrier()
    solver_seconds = time.perf_counter() - t0
    if avg_phase_t0 is not None and t > avg_phase_start_t:
        timing["avg_steps_per_second"] = (t - avg_phase_start_t) / max(
            time.perf_counter() - avg_phase_t0, 1e-9)
    timing["solver_seconds"] = solver_seconds
    timing["mlups"] = info.mlups()
    # seconds of the solver's that went to writing snapshots, frames and
    # checkpoints (host clock); the load precedes the solver's clock
    for kind, on in (("snapshot", unsteady and s.snapshots), ("frame", frames),
                     ("checkpoint_save", ckpt_path is not None),
                     ("checkpoint_load", resume_t)):
        if on:
            timing[f"{kind}_seconds"] = spent[kind]

    if mesh is not None:
        state = gather_state(state)
        if avg is not None:
            avg = _gather_avg(avg, mesh)
    if writes:
        write_final_outputs(case, state, avg, avg_samples, t, files,
                            skip_raw_u=(last_unsteady_t == t))

    progress.done("Solving CFD", f"{t}/{total_steps} steps")
    return RunResult(state=state, avg=avg, total_steps=t,
                     solver_seconds=solver_seconds, files=files, timing=timing)


def write_final_outputs(case: SolverCase, state: LBMState,
                        avg: Optional[AvgState], avg_samples: int, t: int,
                        files: List[Path], *, skip_raw_u: bool = False,
                        ) -> List[Path]:
    """Finalize one case: transient u/rho[/T] VTKs, the `_avg` VTK with
    u_avg/rho_avg[/T_avg]/fluid + the requested tke/TI/TLS, the probe CSVs
    and transform.info (reference setup.cpp:4718-4798, 2513-2683).  File
    names and fields are the JAX package's."""
    s = case.settings
    u_factor = case.units.si_u(1.0)
    rho_factor = case.units.si_rho(1.0)
    dt_si = case.units.si_t(1)
    vtk_dir = case.parent / "RESULTS" / "vtk"
    raw_base = f"{case.vtk_prefix}{case.datetime}_raw_"

    def write_raw(name: str, data: np.ndarray, affine_T: bool = False):
        arr = np.asarray(data)
        if affine_T:
            arr = arr * case.units.unit_K + case.units.unit_K_offset
        path = vtk_dir / vtk_timestep_name(raw_base + name, t)
        write_structured_points(
            path, {"data": arr.astype(np.float32)},
            spacing=case.cell_m, origin_shift=case.origin_shift,
            nz_write=case.nz_out)
        files.append(path)

    if not skip_raw_u:
        write_raw("u", state.u.cpu().numpy() * u_factor)
    write_raw("rho", state.rho.cpu().numpy() * rho_factor)
    if case.thermal_output and state.T is not None:
        write_raw("T", state.T.cpu().numpy(), affine_T=True)

    if avg is not None and avg_samples > 0:
        mean_u = avg.mean_u.cpu().numpy()
        var_sum = variance_sum_u(avg).cpu().numpy()
        flags = state.flags.cpu().numpy()
        fields: Dict[str, np.ndarray] = {
            "u_avg": (mean_u * u_factor).astype(np.float32),
            "rho_avg": (avg.mean_rho.cpu().numpy() * rho_factor).astype(np.float32),
        }
        if case.thermal_output and avg.mean_T is not None:
            fields["T_avg"] = (avg.mean_T.cpu().numpy() * case.units.unit_K
                               + case.units.unit_K_offset).astype(np.float32)
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

    for p in case.probes:
        files.append(p.write_csv(case.parent / "RESULTS"))

    if s.research_output > 0:
        info_path = case.parent / "proj_temp" / "transform.info"
        info_path.parent.mkdir(parents=True, exist_ok=True)
        info_path.write_text(f"dt = {dt_si:.10f}s\n")
        files.append(info_path)
    return files
