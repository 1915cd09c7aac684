"""Case assembly helpers shared by the three run modes.

Reproduces the reference's parameter block (setup.cpp:3480-3860): unit
anchoring (lbm_ref_u = 0.10 at si_ref_u; si_nu = 1.48e-5; si_rho = 1.225;
thermal alpha 2.1e-5, beta = 1/T_ref), Coriolis Omega from the domain-center
latitude, buffer-nudging / top-sponge lattice conversions, and run settings
from the deck.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..deck import DeckDocument
from ..lbm.forcing import NudgeSpec, SpongeSpec
from ..units import Units

LBM_REF_U = 0.10
SI_NU_AIR = 1.48e-5
SI_RHO_AIR = 1.225
SI_ALPHA_AIR = 2.10e-5
TEMPERATURE_REF_K = 293.15
TEMPERATURE_MIN_K = 223.15
TEMPERATURE_MAX_K = 343.15
OMEGA_EARTH_SI = 7.292115e-5
DEFAULT_BASE_HEIGHT = 50.0


def si_size_from_deck(deck: DeckDocument) -> Tuple[float, float, float]:
    out = []
    for key in ("si_x_cfd", "si_y_cfd", "si_z_cfd"):
        pair = deck.get_pair(key)
        if pair is None:
            raise ValueError(f"deck missing {key}")
        out.append(pair[1] - pair[0])
    return tuple(out)


def anchor_units(cell_m: float, si_ref_u: float, *,
                 temp_scale_k: float = TEMPERATURE_REF_K,
                 temp_ref_k: float = TEMPERATURE_REF_K) -> Units:
    """LUW anchoring: 1 cell = cell_m, lattice 0.10 = si_ref_u, rho 1 = 1.225,
    lattice T=1 at temp_ref_k with scale temp_scale_k per unit."""
    u = Units()
    u.set_m_kg_s_K(1.0, LBM_REF_U, 1.0, 1.0, cell_m, si_ref_u, SI_RHO_AIR, temp_scale_k)
    u.set_temperature_reference(1.0, temp_ref_k)
    return u


def coriolis_lbmu(deck: DeckDocument, cell_m: float, si_ref_u: float) -> np.ndarray:
    """Omega vector in lattice units per step (ENU), from domain-center latitude."""
    if not deck.get_bool("coriolis_term", False):
        return np.zeros(3, dtype=np.float32)
    lat_pair = deck.get_pair("cut_lat_manual")
    center_lat = 0.5 * sum(lat_pair) if lat_pair else deck.get_float("center_lat", 0.0) or 0.0
    lat = math.radians(center_lat)
    dt_si = cell_m * (LBM_REF_U / si_ref_u)
    return np.array([
        0.0,
        OMEGA_EARTH_SI * math.cos(lat) * dt_si,
        OMEGA_EARTH_SI * math.sin(lat) * dt_si,
    ], dtype=np.float32)


def nudge_spec_from_deck(deck: DeckDocument, *, cell_m: float, si_ref_u: float,
                         grid: Tuple[int, int, int], downstream_bc: str) -> Optional[NudgeSpec]:
    if not deck.get_bool("enable_buffer_nudging", True):
        return None
    tau = deck.get_float("buffer_tau_s", 300.0)
    if tau is None or tau <= 0:
        return None
    thickness = deck.get_float("buffer_thickness_m", 160.0)
    nz, ny, nx = grid
    max_nbuf = max(1, min(nx, ny, nz) // 4)
    nbuf = min(max(1, int(round(thickness / cell_m))), max_nbuf)
    dt_si = cell_m * (LBM_REF_U / si_ref_u)
    face_map = {"-x": 1, "+x": 2, "-y": 3, "+y": 4}
    return NudgeSpec(
        n_cells=nbuf,
        inv_tau=dt_si / tau,
        vertical=bool(deck.get_bool("buffer_nudge_vertical", False)),
        downstream_face=face_map.get(downstream_bc, 0),
    )


def sponge_spec_from_deck(deck: DeckDocument, *, cell_m: float, si_ref_u: float,
                          nz: int, extended: bool) -> Optional[SpongeSpec]:
    if not (extended and deck.get_bool("enable_top_sponge", True)):
        return None
    tau = deck.get_float("sponge_tau_s", 120.0)
    if tau is None or tau <= 0:
        return None
    ref_mode_raw = (deck.get_text("sponge_ref_mode", "0") or "0").lower()
    if ref_mode_raw not in ("0", "mode0"):
        return None  # geostrophic mode not implemented (matches reference warning)
    thickness = deck.get_float("sponge_thickness_m", 200.0)
    ns = min(max(1, int(round(thickness / cell_m))), max(1, nz - 2))
    dt_si = cell_m * (LBM_REF_U / si_ref_u)
    return SpongeSpec(n_cells=ns, inv_tau=dt_si / tau, ref_mode=0)


def storage_from_deck(deck: DeckDocument) -> str:
    """DDF storage codec for solver runs (`lbm_storage`, default bf16).

    The reference stores DDFs as FP16C (1-4-11 custom float, defines.hpp:14)
    by default, with FP16S/FP32 options; bf16 has the same 2-byte footprint
    and converts natively on the GPU.  The port's kernels take all four
    storages (`csrc/codec.cuh` holds the f16 and fp16c codecs).
    """
    raw = (deck.get_text("lbm_storage", "bf16") or "bf16").strip().lower()
    if raw not in ("bf16", "f16", "fp16c", "f32"):
        raise ValueError(f"lbm_storage must be bf16|f16|fp16c|f32, got {raw!r}")
    return raw


def wall_cd_from_deck(deck: DeckDocument, cell_m: float) -> float:
    """Schumann wall-stress coefficient from the deck's `ground_z0`.

    Cd = [kappa / ln(z1/z0)]^2 with z1 = cell/2 (the first fluid cell
    center's height above a halfway wall) and kappa = 0.41.  Returns 0
    when the wall model is off (ground_z0 absent or <= 0).  The ratio is
    clamped at e so pathological z0 >= z1 stays finite (Cd <= kappa^2)."""
    import math

    z0 = deck.get_float("ground_z0", 0.0) or 0.0
    if z0 <= 0.0:
        return 0.0
    ratio = max((0.5 * cell_m) / z0, math.e)
    return (0.41 / math.log(ratio)) ** 2


def apply_wall_model(config, deck: DeckDocument, cell_m: float):
    """StepConfig with the deck's wall model applied (after force
    specialization — the Schumann stress needs the Guo path compiled in).

    `building_z0` additionally enables the vertical-face wall model
    (wall_sides): specular x/y mirrors replace stair-step bounce-back's
    O(cell) artificial roughness on building walls, with the tangential
    Schumann stress at Cd([kappa/ln(z1/z0_b)]^2).  `building_z0 = -1`
    selects pure free-slip sides (Cd = 0)."""
    import math
    from dataclasses import replace

    cd = wall_cd_from_deck(deck, cell_m)
    if cd <= 0.0:
        return config
    config = replace(config, wall_model=True, wall_cd=cd, volume_force=True)
    z0b = deck.get_float("building_z0", 0.0) or 0.0
    if z0b < 0.0:
        config = replace(config, wall_sides=True, wall_cd_sides=0.0)
    elif z0b > 0.0:
        ratio = max((0.5 * cell_m) / z0b, math.e)
        config = replace(config, wall_sides=True,
                         wall_cd_sides=(0.41 / math.log(ratio)) ** 2)
    return config


def run_settings_from_deck(deck: DeckDocument):
    from .driver import RunSettings

    tokens = [t.lower() for t in deck.get_list("output_tke_ti_tls")]
    fields = tuple(t for t in ("tke", "ti", "tls") if not tokens or t in tokens)
    return RunSettings(
        run_nstep=deck.get_int("run_nstep", 0) or 0,
        research_output=deck.get_int("research_output", 0) or 0,
        unsteady_output=deck.get_int("unsteady_output", 0) or 0,
        purge_avg=deck.get_int("purge_avg", 0) or 0,
        purge_avg_stride=deck.get_int("purge_avg_stride", 1) or 1,
        output_fields=fields,
        frame_output=deck.get_int("frame_output", 0) or 0,
    )
