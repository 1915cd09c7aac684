"""A case's tables worked out again from the deck's inputs.

What the program's set-up derives from a deck (the lattice plan, the flags,
the initial velocity, the forcing fields, the step configuration, the face
targets and the VK inlet), computed by the frozen copies in this package
from the same raw inputs: the deck, its STL and `wind_bc/profile.dat`.  The
arithmetic is the port's profile-research and dataset-generation set-up
(`run/modes.py`) at the state it had when the benchmark was made; the
benchmark holds the program's own set-up to it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .case import (
    DEFAULT_BASE_HEIGHT, LBM_REF_U, SI_NU_AIR, anchor_units, apply_wall_model,
    coriolis_lbmu, nudge_spec_from_deck, si_size_from_deck,
    sponge_spec_from_deck, storage_from_deck,
)
from .deck import load_deck
from .flux import apply_flux_correction
from .forcing import build_forcing
from .lattice import omega_from_nu
from .profile import (
    ProfileTable, direction_from_angle, downstream_from_direction,
    load_profile_dat, profile_boundary_fields,
)
from .sizing import plan_grid
from .state import Forcing, StepConfig, TYPE_E, TYPE_S
from .stl import Mesh, read_stl
from .step import FaceBC, build_face_bc
from .vk_inlet import build_vk_runtime, make_vk_pre_step, vk_config_from_deck
from .voxelize import voxelize_mesh_columns


@dataclass
class Tables:
    """One case as the reference builds it (host arrays and tensors on
    `device`)."""

    shape: tuple
    flags: np.ndarray            # (Z, Y, X) uint8
    u0: np.ndarray               # (3, Z, Y, X) float32, the initial velocity
    forcing: Forcing
    config: StepConfig
    dyn: torch.Tensor            # (8,) the dynamic row
    fbc0: Optional[FaceBC]       # face targets of the initial field
    vk: Optional[object]         # the inlet hook (.ddf with .init_aux, .kernel_spec)
    u_factor: float
    rho_factor: float
    cell_m: float
    nz_out: int
    T0: Optional[np.ndarray] = None  # (Z, Y, X) float32, a thermal case's initial T


def _find_stl(parent: Path, casename: str, suffix: str) -> Path:
    for c in (parent / "proj_temp" / f"{casename}{suffix}.stl",
              parent / "proj_temp" / f"{casename}_DG.stl",
              parent / "proj_temp" / f"{casename}.stl"):
        if c.exists():
            return c
    raise FileNotFoundError(f"no case STL under {parent / 'proj_temp'}")


def _voxelize(mesh: Mesh, plan) -> np.ndarray:
    tris = (np.asarray(mesh.tris, dtype=np.float64) - mesh.pmin) / plan.cell_m
    return voxelize_mesh_columns(Mesh(tris=tris.astype(np.float32)),
                                 (plan.nz, plan.ny, plan.nx))


def _specialize_force(config: StepConfig, forcing, omega_cor) -> StepConfig:
    uses = (forcing.nudge_sigma is not None
            or forcing.sponge_sigma_z is not None
            or config.thermal
            or bool(np.any(np.asarray(omega_cor))))
    return config if uses == config.volume_force else replace(
        config, volume_force=uses)


def _dyn_row(omega_cor, device) -> torch.Tensor:
    row = torch.zeros(8, dtype=torch.float32)
    row[3:6] = torch.as_tensor(np.asarray(omega_cor, np.float32))
    return row.to(device)


def profile_case(deck_path: Path, angle: float, device) -> Tables:
    """The profile-research case at `angle` (a deck without a DEM)."""
    deck_path = Path(deck_path)
    deck = load_deck(deck_path)
    parent = deck_path.parent
    if (parent / "proj_temp" / "interpolated_dem.csv").exists():
        raise NotImplementedError("the reference builds profile decks without a DEM")
    casename = deck.get_text("casename", "case")
    si_size = si_size_from_deck(deck)
    z_offset = deck.get_float("base_height", DEFAULT_BASE_HEIGHT)
    z_samples, u_samples = load_profile_dat(parent / "wind_bc" / "profile.dat")
    domain_agl = si_size[2] - z_offset
    si_ref_u = float(np.max(u_samples))
    storage = storage_from_deck(deck)
    mesh_control = (deck.get_text("mesh_control", "gpu_memory") or "gpu_memory").lower()
    cell_size = deck.get_float("cell_size")
    ngpu = tuple(int(v) for v in ((deck.get_int_list("n_gpu") or [1, 1, 1])
                                  + [1, 1, 1])[:3])
    sponge_on = deck.get_bool("enable_top_sponge", True) and (
        deck.get_float("sponge_tau_s", 120.0) or 0) > 0
    plan = plan_grid(
        si_size,
        cell_m=cell_size if mesh_control == "cell_size" and cell_size else None,
        memory_mb=deck.get_int("gpu_memory", 20000), n_devices=int(np.prod(ngpu)),
        storage=storage, thermal=False,
        sponge_thickness_m=deck.get_float("sponge_thickness_m", 200.0) or 0.0,
        sponge_enabled=sponge_on)
    units = anchor_units(plan.cell_m, si_ref_u)
    u_scale = LBM_REF_U / si_ref_u
    table = ProfileTable.build(z_samples, u_samples,
                               (plan.nz - 0.5) * plan.cell_m, domain_agl)
    solid = _voxelize(read_stl(_find_stl(parent, casename, "_PF")), plan)
    ground = z_offset / plan.cell_m + 0.5
    config = StepConfig(omega=omega_from_nu(units.nu(SI_NU_AIR)),
                        collision="srt", subgrid=True, thermal=False,
                        storage=storage)
    omega_cor = coriolis_lbmu(deck, plan.cell_m, si_ref_u)
    shape = (plan.nz, plan.ny, plan.nx)
    dir_x, dir_y = direction_from_angle(angle)
    downstream = downstream_from_direction(dir_x, dir_y)
    flags, u = profile_boundary_fields(
        shape, table=table, cell_m=plan.cell_m, u_scale=u_scale,
        ground_z_lbm=ground, dir_x=dir_x, dir_y=dir_y, solid=solid,
        downstream_bc=downstream,
        downstream_open=deck.get_bool("downstream_open_face", False),
        side_ref_z_cap=plan.side_ref_z_cap)
    if deck.get_bool("flux_correction", False):
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
            return np.stack([_dx * speed, _dy * speed,
                             np.zeros(shape)]).astype(np.float32)

        flags, u, _ = apply_flux_correction(
            flags, u, downstream_bc=downstream, downstream_eval=ds_eval)
    nudge = nudge_spec_from_deck(deck, cell_m=plan.cell_m, si_ref_u=si_ref_u,
                                 grid=shape, downstream_bc=downstream)
    sponge = sponge_spec_from_deck(deck, cell_m=plan.cell_m, si_ref_u=si_ref_u,
                                   nz=plan.nz, extended=plan.sponge_extended)
    forcing = build_forcing(shape, nudge=nudge, sponge=sponge, device=device)
    config = apply_wall_model(_specialize_force(config, forcing, omega_cor),
                              deck, plan.cell_m)
    vk_cfg = vk_config_from_deck(deck, units=units, downstream_bc=downstream)
    vk_rt = build_vk_runtime(vk_cfg, flags, u)
    vk = None if vk_rt is None else make_vk_pre_step(vk_cfg, vk_rt, device=device).ddf
    u = np.asarray(u, np.float32)
    return Tables(
        shape=shape, flags=np.asarray(flags, np.uint8), u0=u, forcing=forcing,
        config=config, dyn=_dyn_row(omega_cor, device),
        fbc0=build_face_bc(torch.from_numpy(u).to(device)),
        vk=vk, u_factor=units.si_u(1.0), rho_factor=units.si_rho(1.0),
        cell_m=plan.cell_m, nz_out=plan.nz_core if plan.sponge_extended else 0)


def datagen_case(deck_path: Path, inflow: float, angle: float, device) -> Tables:
    """The dataset-generation case at (`inflow`, `angle`)."""
    deck_path = Path(deck_path)
    deck = load_deck(deck_path)
    parent = deck_path.parent
    inflows = deck.get_float_list("inflow")
    casename = deck.get_text("casename", "case")
    si_size = si_size_from_deck(deck)
    si_ref_u = max(inflows)
    storage = storage_from_deck(deck)
    mesh_control = (deck.get_text("mesh_control", "gpu_memory") or "gpu_memory").lower()
    cell_size = deck.get_float("cell_size")
    ngpu = tuple(int(v) for v in ((deck.get_int_list("n_gpu") or [1, 1, 1])
                                  + [1, 1, 1])[:3])
    plan = plan_grid(
        si_size,
        cell_m=cell_size if mesh_control == "cell_size" and cell_size else None,
        memory_mb=deck.get_int("gpu_memory", 20000), n_devices=int(np.prod(ngpu)),
        storage=storage, thermal=False, sponge_thickness_m=0.0,
        sponge_enabled=False)
    units = anchor_units(plan.cell_m, si_ref_u)
    u_scale = LBM_REF_U / si_ref_u
    solid = _voxelize(read_stl(_find_stl(parent, casename, "_DG")), plan)
    config = StepConfig(omega=omega_from_nu(units.nu(SI_NU_AIR)),
                        collision="srt", subgrid=True, storage=storage)
    omega_cor = coriolis_lbmu(deck, plan.cell_m, si_ref_u)
    shape = (plan.nz, plan.ny, plan.nx)
    dir_x, dir_y = direction_from_angle(angle)
    downstream = downstream_from_direction(dir_x, dir_y)
    speed_lbm = inflow * u_scale
    flags = np.where(solid, np.uint8(TYPE_S), np.uint8(0))
    flags[0] = TYPE_S
    u = np.zeros((3, *shape), np.float32)
    u[0] = dir_x * speed_lbm
    u[1] = dir_y * speed_lbm
    u[:, (flags & TYPE_S) != 0] = 0.0
    boundary = np.zeros(shape, dtype=bool)
    boundary[:, :, 0] = boundary[:, :, -1] = True
    boundary[:, 0, :] = boundary[:, -1, :] = True
    boundary[-1] = True
    boundary[0] = False
    flags[boundary & ((flags & TYPE_S) == 0)] |= TYPE_E
    nudge = nudge_spec_from_deck(deck, cell_m=plan.cell_m, si_ref_u=si_ref_u,
                                 grid=shape, downstream_bc=downstream)
    forcing = build_forcing(shape, nudge=nudge, sponge=None, device=device)
    config = apply_wall_model(_specialize_force(config, forcing, omega_cor),
                              deck, plan.cell_m)
    return Tables(
        shape=shape, flags=flags, u0=u, forcing=forcing, config=config,
        dyn=_dyn_row(omega_cor, device),
        fbc0=build_face_bc(torch.from_numpy(u).to(device)),
        vk=None, u_factor=units.si_u(1.0), rho_factor=units.si_rho(1.0),
        cell_m=plan.cell_m, nz_out=0)
