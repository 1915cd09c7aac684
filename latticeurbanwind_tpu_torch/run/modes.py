"""Run modes: profile research (.luwpf).

Counterpart of `latticeurbanwind_tpu/run/modes.py::run_profile_mode` and
`run_deck` (reference: setup.cpp:5762-6153): per-angle cases with inflow
from a cubic-interpolated AGL wind profile (wind_bc/profile.dat), optional
DEM ground from proj_temp/interpolated_dem.csv, the downstream face from the
angle, flux correction, and `ANG_<a>_` VTK prefixes when multi-angle.

Only `.luwpf` decks run in this port; `.luw`, `.luwdg`, `case_parallel` and
an active VK inlet raise `NotImplementedError` naming the ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import replace
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..bc.flux import apply_flux_correction
from ..bc.profile import (
    ProfileTable, direction_from_angle, downstream_from_direction,
    load_profile_dat, profile_boundary_fields,
)
from ..deck import deck_mode_from_path, load_deck
from ..geometry import Mesh, read_stl, voxelize_mesh_columns
from ..io.progress import ProgressEmitter
from ..lbm.forcing import build_forcing
from ..lbm.lattice import omega_from_nu
from ..lbm.state import DynParams, StepConfig, make_initial_state
from .case import (
    DEFAULT_BASE_HEIGHT, LBM_REF_U, SI_NU_AIR,
    anchor_units, apply_wall_model, coriolis_lbmu, nudge_spec_from_deck,
    run_settings_from_deck, si_size_from_deck, sponge_spec_from_deck,
    storage_from_deck,
)
from .driver import RunResult, SolverCase, run_case
from .sizing import plan_grid


def _format_tag(v: float) -> str:
    """Compact number tag used in batch VTK prefixes (e.g. ANG_90_)."""
    if abs(v - round(v)) < 1e-6:
        return str(int(round(v)))
    return f"{v:g}"


def _find_case_stl(parent: Path, casename: str) -> Path:
    """Geometry search order (reference: setup.cpp:4001-4067)."""
    candidates = [
        parent / "proj_temp" / f"{casename}_PF.stl",
        parent / "proj_temp" / f"{casename}_DG.stl",
        parent / "proj_temp" / f"{casename}.stl",
    ]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(f"no case STL found; tried {[str(c) for c in candidates]}")


def _specialize_force(config: StepConfig, forcing, omega_cor) -> StepConfig:
    """Leave the Guo forcing terms out when the case exerts no volume force
    (no nudge/sponge, no Coriolis, no thermal buoyancy) — the reference's
    VOLUME_FORCE-off build (defines.hpp)."""
    uses = (forcing.nudge_sigma is not None
            or forcing.sponge_sigma_z is not None
            or config.thermal
            or bool(np.any(np.asarray(omega_cor))))
    return config if uses == config.volume_force else replace(
        config, volume_force=uses)


def _voxelize_case(mesh: Mesh, plan, progress: ProgressEmitter) -> np.ndarray:
    """STL (SI, aligned to its own min corner) -> solid mask on the lattice."""
    progress.emit("Voxelizing geometry", indeterminate=True, force=True)
    tris = (np.asarray(mesh.tris, dtype=np.float64) - mesh.pmin) / plan.cell_m
    lattice_mesh = Mesh(tris=tris.astype(np.float32))
    solid = voxelize_mesh_columns(lattice_mesh, (plan.nz, plan.ny, plan.nx))
    progress.done("Voxelizing geometry")
    return solid


def _load_dem_ground(parent: Path) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """proj_temp/interpolated_dem.csv -> (x, y, elevation) SI arrays."""
    path = parent / "proj_temp" / "interpolated_dem.csv"
    if not path.exists():
        return None
    xs, ys, es = [], [], []
    for line in path.read_text().splitlines():
        parts = line.replace(";", ",").split(",")
        if len(parts) < 3:
            continue
        try:
            x, y, e = float(parts[0]), float(parts[1]), float(parts[2])
        except ValueError:
            continue
        xs.append(x)
        ys.append(y)
        es.append(e)
    if not xs:
        return None
    return np.asarray(xs), np.asarray(ys), np.asarray(es)


def _ground_map_from_dem(dem, plan, z_offset_si: float, stl_size) -> np.ndarray:
    """Nearest-sample DEM elevation per (y, x) column in cell-center lattice z
    (affine DEM -> STL footprint alignment, reference setup.cpp:5789-5817)."""
    xs, ys, es = dem
    dem_rx = xs.max() - xs.min()
    dem_ry = ys.max() - ys.min()
    sx = stl_size[0] / dem_rx if dem_rx > 1e-6 else 1.0
    sy = stl_size[1] / dem_ry if dem_ry > 1e-6 else 1.0
    gx = (xs - xs.min()) * sx / plan.cell_m
    gy = (ys - ys.min()) * sy / plan.cell_m
    gz = (z_offset_si + es) / plan.cell_m + 0.5

    ground = np.full((plan.ny, plan.nx), (z_offset_si / plan.cell_m) + 0.5)
    ix = np.clip(np.rint(gx).astype(int), 0, plan.nx - 1)
    iy = np.clip(np.rint(gy).astype(int), 0, plan.ny - 1)
    ground[iy, ix] = gz
    # fill gaps by nearest sample via simple dilation passes
    filled = ground.copy()
    mask = np.zeros_like(ground, dtype=bool)
    mask[iy, ix] = True
    for _ in range(8):
        if mask.all():
            break
        shifted = [np.roll(filled, s, a) for s, a in
                   ((1, 0), (-1, 0), (1, 1), (-1, 1))]
        smask = [np.roll(mask, s, a) for s, a in ((1, 0), (-1, 0), (1, 1), (-1, 1))]
        for arr, m in zip(shifted, smask):
            take = ~mask & m
            filled[take] = arr[take]
            mask |= m
    return np.clip(filled, 0.5, plan.nz - 0.5)


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def run_profile_mode(deck_path: Path | str, *,
                     device: torch.device | str | None = None,
                     quiet: bool = False, max_cases: int = 0) -> List[RunResult]:
    """Execute the .luwpf profile-research batch on `device` (default: the
    first CUDA device when there is one, else the CPU)."""
    dev = torch.device(device) if device is not None else default_device()
    deck_path = Path(deck_path)
    deck = load_deck(deck_path)
    parent = deck_path.parent
    progress = ProgressEmitter("interface_interpolation")

    if deck.get_bool("case_parallel", False):
        raise NotImplementedError(
            "case_parallel is not ported yet (ROADMAP module item 10)")
    if deck.get_bool("turb_inflow_enable", True):
        raise NotImplementedError(
            "the VK synthetic-turbulence inlet is not ported yet (ROADMAP "
            "module item 7, kernel item K6); set turb_inflow_enable = false")
    angles = deck.get_float_list("angle")
    if not angles:
        raise ValueError("profile mode requires angle=[...] in the deck")
    casename = deck.get_text("casename", "case")
    datetime_tag = deck.get_text("datetime", "00000000000000")
    si_size = si_size_from_deck(deck)
    z_offset = deck.get_float("base_height", DEFAULT_BASE_HEIGHT)

    z_samples, u_samples = load_profile_dat(parent / "wind_bc" / "profile.dat")
    if len(z_samples) < 2:
        raise ValueError("profile.dat needs at least two valid samples")
    domain_agl = si_size[2] - z_offset
    if domain_agl <= 0:
        raise ValueError("invalid profile domain height (si_z_cfd vs base_height)")
    si_ref_u = float(np.max(u_samples))
    if si_ref_u <= 0:
        raise ValueError("profile.dat has non-positive max U")

    storage = storage_from_deck(deck)
    mesh_control = (deck.get_text("mesh_control", "gpu_memory") or "gpu_memory").lower()
    cell_size = deck.get_float("cell_size")
    memory_mb = deck.get_int("gpu_memory", 20000)
    ngpu = tuple(int(v) for v in ((deck.get_int_list("n_gpu") or [1, 1, 1])
                                  + [1, 1, 1])[:3])
    sponge_on = deck.get_bool("enable_top_sponge", True) and (
        deck.get_float("sponge_tau_s", 120.0) or 0) > 0
    plan = plan_grid(
        si_size,
        cell_m=cell_size if mesh_control == "cell_size" and cell_size else None,
        memory_mb=memory_mb, n_devices=int(np.prod(ngpu)),
        storage=storage, thermal=False,
        sponge_thickness_m=deck.get_float("sponge_thickness_m", 200.0) or 0.0,
        sponge_enabled=sponge_on,
    )
    units = anchor_units(plan.cell_m, si_ref_u)
    u_scale = LBM_REF_U / si_ref_u

    table_top_si = (plan.nz - 0.5) * plan.cell_m
    table = ProfileTable.build(z_samples, u_samples, table_top_si, domain_agl)

    mesh = read_stl(_find_case_stl(parent, casename))
    t_vox = time.perf_counter()
    solid = _voxelize_case(mesh, plan, progress)
    voxelize_seconds = time.perf_counter() - t_vox

    ground = z_offset / plan.cell_m + 0.5
    dem = _load_dem_ground(parent)
    if dem is not None:
        ground = _ground_map_from_dem(dem, plan, z_offset, mesh.size)

    config = StepConfig(
        omega=omega_from_nu(units.nu(SI_NU_AIR)),
        collision="srt", subgrid=True, thermal=False,
        storage=storage,
    )
    settings = run_settings_from_deck(deck)
    flux_on = deck.get_bool("flux_correction", False)
    downstream_open = deck.get_bool("downstream_open_face", False)
    omega_cor = coriolis_lbmu(deck, plan.cell_m, si_ref_u)

    shape = (plan.nz, plan.ny, plan.nx)
    single = len(angles) == 1
    results: List[RunResult] = []
    for idx, angle in enumerate(angles):
        if max_cases and idx >= max_cases:
            break
        if results:   # free the previous case's device memory first
            results[-1].release_device_state()
        dir_x, dir_y = direction_from_angle(angle)
        downstream = downstream_from_direction(dir_x, dir_y)
        flags, u = profile_boundary_fields(
            shape, table=table, cell_m=plan.cell_m, u_scale=u_scale,
            ground_z_lbm=ground, dir_x=dir_x, dir_y=dir_y, solid=solid,
            downstream_bc=downstream, downstream_open=downstream_open,
            side_ref_z_cap=plan.side_ref_z_cap,
        )
        if flux_on:
            def ds_eval(mask, _dx=dir_x, _dy=dir_y):
                zc = np.arange(shape[0]) + 0.5
                agl = (zc[:, None, None] - np.broadcast_to(
                    np.asarray(ground), (plan.ny, plan.nx))[None]) * plan.cell_m
                if plan.side_ref_z_cap >= 0:
                    cap_agl = ((plan.side_ref_z_cap + 0.5)
                               - np.asarray(ground)) * plan.cell_m
                    agl = np.where(
                        (np.arange(shape[0]) > plan.side_ref_z_cap)[:, None, None],
                        np.broadcast_to(cap_agl, shape), agl)
                speed = table.speed_at_agl(agl) * u_scale
                full = np.stack([_dx * speed, _dy * speed, np.zeros(shape)])
                return full.astype(np.float32)

            flags, u, report = apply_flux_correction(
                flags, u, downstream_bc=downstream, downstream_eval=ds_eval)
            if not quiet:
                print(f"| Flux correction | net {report['net_before']:+.4f} -> "
                      f"{report['net_after']:+.4f}, avg dU {report['avg_dU']:.5f}")

        nudge = nudge_spec_from_deck(deck, cell_m=plan.cell_m, si_ref_u=si_ref_u,
                                     grid=shape, downstream_bc=downstream)
        sponge = sponge_spec_from_deck(deck, cell_m=plan.cell_m, si_ref_u=si_ref_u,
                                       nz=plan.nz, extended=plan.sponge_extended)
        forcing = build_forcing(shape, nudge=nudge, sponge=sponge, device=dev)
        config = apply_wall_model(
            _specialize_force(config, forcing, omega_cor), deck, plan.cell_m)
        state = make_initial_state(shape, config=config, u=u, flags=flags,
                                   device=dev)
        dyn = DynParams(force=torch.zeros(3),
                        omega_coriolis=torch.as_tensor(omega_cor, dtype=torch.float32))
        prefix = "" if single else f"ANG_{_format_tag(angle)}_"
        case = SolverCase(
            config=config, forcing=forcing, state=state, dyn=dyn, units=units,
            cell_m=plan.cell_m, parent=parent, datetime=datetime_tag,
            vtk_prefix=prefix, nz_out=plan.nz_core if plan.sponge_extended else 0,
            settings=settings, ngpu=ngpu,
        )
        if not quiet:
            print(f"| Profile case    | {idx + 1}/{len(angles)} angle={angle} deg "
                  f"downstream={downstream} grid={plan.nx}x{plan.ny}x{plan.nz} "
                  f"cell={plan.cell_m:.2f} m device={dev}")
        results.append(run_case(case, quiet=quiet))
        results[-1].timing["voxelize_seconds"] = voxelize_seconds
    return results


def run_deck(deck_path: Path | str, **kw) -> List[RunResult]:
    mode = deck_mode_from_path(deck_path)
    if mode == "luwpf":
        return run_profile_mode(deck_path, **kw)
    if mode == "luwdg":
        raise NotImplementedError(
            "dataset-generation decks (.luwdg) are not ported yet (ROADMAP "
            "module item 8)")
    raise NotImplementedError(
        "standard NWP-coupled decks (.luw) are not ported yet (ROADMAP module "
        "item 8)")
