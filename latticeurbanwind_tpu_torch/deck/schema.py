"""Deck schema: the single source of truth for the `.luw/.luwdg/.luwpf` config contract.

The deck is the shared contract between every layer of the framework (pipeline,
solver, post tools, GUI).  This module defines the canonical 9 sections and 77
fields with their value kinds, aliases, and run-mode visibility, plus the
tolerant token normalizers (fuzzy booleans, dash/space key folding) that make
hand-edited decks robust.

Contract parity with the reference implementation:
  the reference's core/deck_schema.json (9 sections, 77 fields)
  the reference's core/deck_schema.py (normalize_key, parse_bool_token)
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Token normalizers
# ---------------------------------------------------------------------------

_SEP_RE = re.compile(r"[\s\-]+")
_MULTI_UNDERSCORE_RE = re.compile(r"_+")

TRUE_TOKENS = frozenset({"1", "true", "t", "yes", "y", "on", "enable", "enabled"})
FALSE_TOKENS = frozenset({"0", "false", "f", "no", "n", "off", "disable", "disabled"})

# Run-mode bitmask: which deck flavours a field applies to.
MODE_BITS = {"luw": 1, "luwdg": 2, "luwpf": 4}
MODE_ALL = 7


def strip_quotes(raw: object) -> str:
    """Remove one level of matched single or double quotes."""
    text = str(raw).strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1].strip()
    return text


def sanitize_key(raw: str) -> str:
    """Fold whitespace/dashes to underscores and lowercase: `VK-Inlet TI` -> `vk_inlet_ti`."""
    text = _SEP_RE.sub("_", str(raw).strip().lower())
    return _MULTI_UNDERSCORE_RE.sub("_", text).strip("_")


def parse_bool_token(raw: object) -> Optional[bool]:
    """Fuzzy boolean: accepts yes/no/on/off/t/f/enable/..., and any finite number (!=0 is True)."""
    if raw is None:
        return None
    text = strip_quotes(raw).lower()
    if not text:
        return None
    if text in TRUE_TOKENS:
        return True
    if text in FALSE_TOKENS:
        return False
    try:
        value = float(text)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(value):
        return None
    return value != 0.0


# ---------------------------------------------------------------------------
# Section and field specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SectionSpec:
    id: str
    title: str
    description: str = ""
    aliases: Tuple[str, ...] = ()


@dataclass(frozen=True)
class FieldSpec:
    key: str
    kind: str  # string|integer|float|boolean|enum|float_pair|float_triplet|uint_triplet|float_list|token_list|multiline
    section: str
    label: str = ""
    help: str = ""
    enum_values: Tuple[str, ...] = ()
    modes: int = MODE_ALL
    quoted: bool = False
    aliases: Tuple[str, ...] = ()
    default: object = None


SECTIONS: Tuple[SectionSpec, ...] = (
    SectionSpec("project", "Project", "Case identity and timestamps.",
                ("project", "project info", "case")),
    SectionSpec("domain", "Domain", "Spatial ranges, clipping, coordinates, terrain voxel controls.",
                ("domain", "projected si range after rotation", "wrf data range in lon/lat")),
    SectionSpec("generated", "Generated", "Values the pipeline writes back into the deck.",
                ("generated", "generated info", "volume-mean uvw and downstream boundary with yaw angle")),
    SectionSpec("cfd", "CFD Controls", "Mesh sizing, chip split, solver controls.",
                ("cfd control", "cfd controls")),
    SectionSpec("output", "Output & Probes", "Output cadence, probes, averaging products.",
                ("output", "output and probes", "output & probes")),
    SectionSpec("physics", "Physics", "Coriolis, buoyancy, nudging and sponge settings.",
                ("physics",)),
    SectionSpec("vk", "Turbulence inflow", "Synthetic turbulence inflow settings.",
                ("turbulence inflow", "vk inlet", "von karman inlet")),
    SectionSpec("batch", "Batch", "Dataset-generation / profile batch controls.",
                ("batch", "batch modes", "dataset generation", "inflow directions")),
    SectionSpec("custom", "Custom", "Unknown keys preserved verbatim.", ("custom",)),
)


def _mk(mode_names) -> int:
    mask = 0
    for name in mode_names:
        mask |= MODE_BITS.get(str(name).lower(), 0)
    return mask or MODE_ALL


_GEO_MODES = _mk(("luw", "luwpf"))
_DG_PF = _mk(("luwdg", "luwpf"))
_DG = _mk(("luwdg",))

FIELDS: Tuple[FieldSpec, ...] = (
    # Project
    FieldSpec("casename", "string", "project", "Case name", "Case identifier used in output names."),
    FieldSpec("datetime", "string", "project", "Date & time", "14-digit timestamp keying the case artifacts."),
    # Domain
    FieldSpec("cut_lon_manual", "float_pair", "domain", "Longitude range", "Manual longitude clip range."),
    FieldSpec("cut_lat_manual", "float_pair", "domain", "Latitude range", "Manual latitude clip range."),
    FieldSpec("cut_utm_x", "float_pair", "domain", "UTM X range", "Manual projected UTM X clip range."),
    FieldSpec("cut_utm_y", "float_pair", "domain", "UTM Y range", "Manual projected UTM Y clip range."),
    FieldSpec("si_x_cfd", "float_pair", "domain", "X range", "Projected CFD domain X extent in meters."),
    FieldSpec("si_y_cfd", "float_pair", "domain", "Y range", "Projected CFD domain Y extent in meters."),
    FieldSpec("si_z_cfd", "float_pair", "domain", "Z range", "Projected CFD domain Z extent in meters."),
    FieldSpec("base_height", "float", "domain", "Base height", "Ground slab thickness in meters."),
    FieldSpec("z_limit", "float", "domain", "Height limit", "Low-altitude vertical target range in meters."),
    FieldSpec("geometry_mode", "enum", "domain", "Geometry representation",
              "0 buildings only, 1 terrain only, 2 both.", ("0", "1", "2"), _GEO_MODES),
    FieldSpec("terr_voxel_height_field", "string", "domain", "Height key",
              "Shapefile attribute holding building height; auto-detect when set to a sentinel.", (), _GEO_MODES),
    FieldSpec("terr_voxel_ignore_under", "float", "domain", "Ignore under",
              "Skip buildings at or below this height (m).", (), _GEO_MODES),
    FieldSpec("terr_voxel_approach", "enum", "domain", "Terrain approach",
              "Terrain interpolation backend for voxelization.",
              ("idw", "kriging_gpu", "kriging"), _GEO_MODES),
    FieldSpec("terr_voxel_grid_resolution", "float", "domain", "Grid resolution (m)",
              "Terrain interpolation grid spacing in meters.", (), _GEO_MODES),
    FieldSpec("terr_voxel_idw_sigma", "float", "domain", "IDW sigma",
              "Post-interpolation Gaussian smoothing strength.", (), _GEO_MODES),
    FieldSpec("terr_voxel_idw_power", "float", "domain", "IDW power",
              "Inverse-distance weighting exponent.", (), _GEO_MODES),
    FieldSpec("terr_voxel_idw_neighbors", "integer", "domain", "Neighboring points (N)",
              "DEM sample count per interpolation target.", (), _GEO_MODES),
    FieldSpec("midmesh_basesize", "float", "domain", "Mid-mesh base size",
              "Preprocessing boundary-construction base mesh size."),
    FieldSpec("utm_crs", "string", "domain", "UTM CRS", "Projected CRS identifier.", quoted=True),
    FieldSpec("utm_epsg", "integer", "domain", "UTM EPSG", "Projected EPSG code."),
    FieldSpec("utm", "string", "domain", "UTM string", "Legacy projected CRS string."),
    FieldSpec("utm_zone", "integer", "domain", "UTM zone", "UTM zone number."),
    FieldSpec("utm_hemisphere", "string", "domain", "UTM hemisphere", "N or S."),
    FieldSpec("rotate_deg", "float", "domain", "Rotate angle", "Rotation aligning the CFD box to the wind."),
    FieldSpec("center_lon", "float", "domain", "Center longitude", "Domain center longitude."),
    FieldSpec("center_lat", "float", "domain", "Center latitude", "Domain center latitude."),
    # Generated
    FieldSpec("origin_shift_applied", "boolean", "generated", "Origin shift applied",
              "Whether the origin shift was applied by preprocessing."),
    FieldSpec("um_vol", "float_triplet", "generated", "Volume mean velocity",
              "Volume-mean u,v,w written back by preprocessing."),
    FieldSpec("um_bc", "float_triplet", "generated", "Boundary mean velocity",
              "Boundary-mean u,v,w written back by preprocessing."),
    FieldSpec("downstream_bc", "string", "generated", "Downstream face",
              "Computed downstream boundary face (+x/-x/+y/-y).", quoted=True),
    FieldSpec("downstream_bc_yaw", "float", "generated", "Downstream yaw", "Computed downstream yaw angle."),
    # CFD Controls
    FieldSpec("n_gpu", "uint_triplet", "cfd", "Chip split",
              "Device-split triplet [Dx,Dy,Dz]; maps to the TPU mesh shape."),
    FieldSpec("mesh_control", "enum", "cfd", "Mesh control",
              "Size the grid from a memory budget or an explicit cell size.",
              ("gpu_memory", "cell_size"), quoted=True),
    FieldSpec("gpu_memory", "integer", "cfd", "Memory budget (MiB)",
              "Per-device memory target for automatic resolution sizing."),
    FieldSpec("cell_size", "float", "cfd", "Cell size (m)", "Explicit cell size when mesh_control=cell_size."),
    FieldSpec("validation", "string", "cfd", "Validation status", "Written by prerun validation (pass/error)."),
    FieldSpec("high_order", "boolean", "cfd", "High order interpolation",
              "Use the high-order KNN/quadratic BC interpolator."),
    FieldSpec("flux_correction", "boolean", "cfd", "Flux correction", "Enable global mass-flux correction."),
    FieldSpec("downstream_open_face", "boolean", "cfd", "Downstream open",
              "Treat the downstream face as an open outlet."),
    FieldSpec("run_nstep", "integer", "cfd", "Run steps override", "Override solver run length in steps."),
    FieldSpec("lbm_storage", "enum", "cfd", "DDF storage codec",
              "DDF precision: bf16 (TPU-native, default), fp16c (the "
              "reference's 1-4-11 custom float), f16 (FP16S analog), f32.",
              ("bf16", "fp16c", "f16", "f32")),
    FieldSpec("case_parallel", "boolean", "cfd", "Case-parallel batches",
              "TPU extension: run .luwdg/.luwpf batch cases in parallel, "
              "one case per device over the mesh (run/batch.py)."),
    FieldSpec("research_output", "integer", "cfd", "Research output stride", "Research snapshot cadence."),
    # Output & Probes
    FieldSpec("unsteady_output", "integer", "output", "Unsteady output stride", "Write unsteady VTK every N steps."),
    FieldSpec("frame_output", "integer", "output", "Video frame stride",
              "Render a perspective 3-D PNG frame every N steps "
              "(ffmpeg-ready sequence in proj_temp/frames)."),
    FieldSpec("probes_output", "integer", "output", "Probe output stride", "Probe sampling interval."),
    FieldSpec("purge_avg", "integer", "output", "Average purge stride", "Number of final steps averaged."),
    FieldSpec("purge_avg_stride", "integer", "output", "Average purge sub-stride", "Averaging subsample stride."),
    FieldSpec("output_tke_ti_tls", "token_list", "output", "Averaged scalar outputs",
              "Subset of tke, ti, tls added to the averaged VTK."),
    FieldSpec("probes", "multiline", "output", "Probe definitions", "Probe definition tokens."),
    # Physics
    FieldSpec("coriolis_term", "boolean", "physics", "Coriolis term", "Enable the Coriolis source term."),
    FieldSpec("ground_z0", "float", "physics", "Ground roughness length",
              "TPU extension: aerodynamic roughness z0 (m) of horizontal "
              "solid faces.  >0 enables the LES wall model (specular "
              "ground streaming + Schumann log-law shear stress) — removes "
              "the stair-step bounce-back's artificial O(cell) roughness "
              "on coarse urban grids.  0 (default) keeps plain bounce-back "
              "(reference parity)."),
    FieldSpec("building_z0", "float", "physics", "Building-wall roughness",
              "TPU extension (needs ground_z0 > 0): roughness z0 (m) of "
              "VERTICAL solid faces.  >0 enables the side wall model "
              "(specular x/y streaming + tangential Schumann stress) — at "
              "2-4 m cells stair-step bounce-back imposes ~O(cell) "
              "sand-grain roughness on hydraulically smooth building "
              "walls, over-damping street-canyon flow.  -1 = pure "
              "free-slip sides; 0 (default) keeps bounce-back walls."),
    FieldSpec("buoyancy", "boolean", "physics", "Buoyancy", "Enable Boussinesq temperature coupling."),
    FieldSpec("ibm_enabler", "boolean", "physics", "Immersed boundary", "Enable immersed-boundary handling."),
    FieldSpec("enable_buffer_nudging", "boolean", "physics", "Buffer nudging", "Enable lateral buffer nudging."),
    FieldSpec("buffer_thickness_m", "float", "physics", "Buffer thickness", "Nudging band thickness (m)."),
    FieldSpec("buffer_tau_s", "float", "physics", "Buffer tau", "Nudging relaxation timescale (s)."),
    FieldSpec("buffer_nudge_vertical", "boolean", "physics", "Vertical nudging",
              "Nudge the vertical velocity component too."),
    FieldSpec("enable_top_sponge", "boolean", "physics", "Top sponge layer", "Enable top sponge damping."),
    FieldSpec("sponge_thickness_m", "float", "physics", "Sponge thickness", "Top sponge thickness (m)."),
    FieldSpec("sponge_tau_s", "float", "physics", "Sponge tau", "Top sponge timescale (s)."),
    FieldSpec("sponge_ref_mode", "string", "physics", "Sponge reference mode", "0/mode0 or 1/geostrophic."),
    # Turbulence inflow
    FieldSpec("turb_inflow_enable", "boolean", "vk", "Turbulence inflow",
              "Enable synthetic turbulence inflow.", aliases=("vk_inlet_enable",)),
    FieldSpec("turb_inflow_approach", "enum", "vk", "Synthetic approach",
              "Synthetic turbulence generator.", ("vonkarman", "smirnov")),
    FieldSpec("vk_inlet_ti", "float", "vk", "Turbulence intensity", "Turbulence intensity fraction."),
    FieldSpec("vk_inlet_sigma", "float", "vk", "Fluctuation sigma", "Velocity fluctuation sigma (m/s)."),
    FieldSpec("vk_inlet_l", "float", "vk", "Length scale", "Integral length scale (m)."),
    FieldSpec("vk_inlet_nmodes", "integer", "vk", "Mode count", "Number of Fourier modes."),
    FieldSpec("vk_inlet_seed", "string", "vk", "Random seed", "Mode sampling seed."),
    FieldSpec("vk_inlet_update_stride", "integer", "vk", "Update stride", "Inlet refresh interval in steps."),
    FieldSpec("vk_inlet_uc_mode", "enum", "vk", "Characteristic speed mode",
              "Speed used to scale turbulence intensity.", ("NORMAL_COMPONENT", "NORM_MEAN")),
    FieldSpec("vk_inlet_same_realization_all_faces", "boolean", "vk", "Same realization on all faces",
              "Share one random realization across inflow faces."),
    FieldSpec("vk_inlet_stride_interpolation", "boolean", "vk", "Stride interpolation",
              "Interpolate between stride updates."),
    FieldSpec("vk_inlet_inflow_only", "boolean", "vk", "Inflow only",
              "Apply only on side faces other than the outlet."),
    FieldSpec("vk_inlet_anisotropy", "float_triplet", "vk", "Anisotropy",
              "Per-component perturbation gain [ax, ay, az].",
              aliases=("vk_inlet_anisotropy_scale", "vk_inlet_aniso_scale")),
    # Batch
    FieldSpec("x_exp_rat", "float", "batch", "X expansion ratio", "Batch STL base expansion along X.", (), _DG_PF),
    FieldSpec("y_exp_rat", "float", "batch", "Y expansion ratio", "Batch STL base expansion along Y.", (), _DG_PF),
    FieldSpec("inflow", "float_list", "batch", "Inflow list", "Dataset-gen inflow magnitudes (m/s).", (), _DG),
    FieldSpec("angle", "float_list", "batch", "Angle list", "Batch inflow angles (deg).", (), _DG_PF),
)

LIST_KINDS = frozenset({"float_pair", "float_triplet", "uint_triplet", "float_list", "token_list"})

SECTION_ORDER: List[str] = [s.id for s in SECTIONS]
SECTION_TITLES: Dict[str, str] = {s.id: s.title for s in SECTIONS}
SECTION_ALIASES: Dict[str, Tuple[str, ...]] = {s.id: s.aliases for s in SECTIONS}
FIELD_MAP: Dict[str, FieldSpec] = {f.key: f for f in FIELDS}
FIELD_SECTION: Dict[str, str] = {f.key: f.section for f in FIELDS}
FIELD_ORDER: Dict[str, List[str]] = {
    sid: [f.key for f in FIELDS if f.section == sid] for sid in SECTION_ORDER
}

_ALIAS_MAP: Dict[str, str] = {}
for _f in FIELDS:
    _ALIAS_MAP[sanitize_key(_f.key)] = _f.key
    for _a in _f.aliases:
        _ALIAS_MAP[sanitize_key(_a)] = _f.key


def normalize_key(raw: str) -> str:
    """Canonical field key for any accepted spelling (dashes, spaces, aliases)."""
    sanitized = sanitize_key(raw)
    return _ALIAS_MAP.get(sanitized, sanitized)


def export_schema_json() -> dict:
    """Schema as a JSON-serializable dict (for GUI/editor consumers)."""
    return {
        "sections": [
            {"id": s.id, "title": s.title, "description": s.description, "aliases": list(s.aliases)}
            for s in SECTIONS
        ],
        "fields": [
            {
                "key": f.key,
                "label": f.label or f.key,
                "section": f.section,
                "help": f.help,
                "kind": f.kind,
                **({"enum_values": list(f.enum_values)} if f.enum_values else {}),
                **({"quoted": True} if f.quoted else {}),
                **({"aliases": list(f.aliases)} if f.aliases else {}),
                **({"modes": [m for m, b in MODE_BITS.items() if f.modes & b]}
                   if f.modes != MODE_ALL else {}),
            }
            for f in FIELDS
        ],
    }
