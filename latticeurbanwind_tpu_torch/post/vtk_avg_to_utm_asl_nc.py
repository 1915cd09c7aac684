"""Averaged VTK -> UTM/ASL NetCDF export (luwutmnc).

Counterpart of `latticeurbanwind_tpu/post/vtk_avg_to_utm_asl_nc.py` (host
numpy + scipy; tools_core/vtk_avg_to_utm_asl_nc.py): strips the
pedestal rows below the pedestal height, shifts the pedestal top to the
case's terrain-minimum ASL, de-rotates winds to east/north components, and
writes NetCDF-3 on UTM easting/northing axes, byte for byte as the JAX
package writes it.

Two drive modes (reference CLI :531-560):
  * single case: `luwutmnc <deck>` (or --case-dir DIR [--config deck]) —
    every VTK matching --input-glob under --input-subdir converts into
    --output-subdir (the newest RESULTS/vtk average when the crop tree
    does not exist);
  * multi-case batch: `luwutmnc <root> --cases a b c` — each case is
    <root>/<case> with its own deck, terrain ASL from a tolerant Range.txt
    grammar (reference parse_range_asl, :67-117) or --terrain-min-asl.
--compression-level is accepted for the reference CLI and ignored
(NetCDF-3 has no zlib).

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwutmnc conf.luwpf
"""

from __future__ import annotations

import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..deck import load_deck
from ..io.vtk import read_structured_points
from .transform import TransformModel
from .vtk2nc import discover_case_vtk_files

DEFAULT_INPUT_SUBDIR = Path("RESULTS") / "crop" / "cropped_vtk_raw_assembled"
DEFAULT_OUTPUT_SUBDIR = Path("RESULTS") / "nc_utm_asl"
DEFAULT_INPUT_GLOB = "ANG_*_avg-*_cropped.vtk"


def parse_range_asl(range_path: Path,
                    required_cases: Optional[Sequence[str]] = None
                    ) -> Dict[str, float]:
    """Tolerant Range.txt grammar: `<case>: ... <N> m`, a `case:` header
    followed by `terrain_min_asl_m = N` or a bare `N m` line (reference
    parse_range_asl, vtk_avg_to_utm_asl_nc.py:67-117)."""
    if not range_path.is_file():
        raise FileNotFoundError(f"range file not found: {range_path}")
    values: Dict[str, float] = {}
    current: Optional[str] = None
    city_re = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*$")
    explicit_re = re.compile(r"terrain_min_asl_m\s*=\s*([-+]?\d+(?:\.\d+)?)",
                             re.IGNORECASE)
    plain_re = re.compile(r"^\s*([-+]?\d+(?:\.\d+)?)\s*m\s*$", re.IGNORECASE)
    number_m_re = re.compile(r"([-+]?\d+(?:\.\d+)?)\s*m\b", re.IGNORECASE)
    wanted = [c.lower() for c in (required_cases or [])]
    for raw in range_path.read_text(encoding="utf-8",
                                    errors="ignore").splitlines():
        line = raw.strip()
        if not line:
            continue
        lower = line.lower()
        named = next((c for c in wanted if c in lower), None)
        if named is not None:
            nums = number_m_re.findall(line)
            if nums:
                values[named] = float(nums[-1])
                current = None
                continue
        m = city_re.match(line)
        if m:
            current = m.group(1).lower()
            continue
        if current is None:
            continue
        m = explicit_re.search(line)
        if m:
            values[current] = float(m.group(1))
            continue
        m = plain_re.match(line)
        if m:
            values[current] = float(m.group(1))
    return values


def convert(deck_path: Path, vtk_path: Path, *,
            pedestal: Optional[float] = None,
            terrain_min_asl: float = 0.0,
            out_dir: Optional[Path] = None,
            overwrite: bool = True) -> Optional[Path]:
    """One VTK -> NetCDF.  z = (vtk z - pedestal) + terrain_min_asl
    (reference: shift pedestal top to zero, add the case ASL)."""
    from scipy.io import netcdf_file

    deck = load_deck(deck_path)
    out = ((out_dir or vtk_path.parent.parent)
           / (vtk_path.stem + "_utm_asl.nc"))
    if out.exists() and not overwrite:
        print(f"luwutmnc: skip existing {out.name}")
        return None
    meta, fields = read_structured_points(vtk_path)
    nx, ny, nz = meta["dims"]
    sp = meta["spacing"][0]
    base_h = (pedestal if pedestal is not None
              else deck.get_float("base_height", 50.0) or 50.0)
    k0 = int(np.ceil(base_h / sp))           # strip pedestal rows

    model = TransformModel.from_deck(deck, (nx * sp, ny * sp))
    # 1-D UTM axes for the (small-residual-rotation) grid: the local frame
    # shifted by the rotated-window origin (the residual convergence angle
    # is recorded as metadata — reference :436 behavior)
    x = (np.arange(nx) + 0.5) * sp
    y = (np.arange(ny) + 0.5) * sp
    easting = model.origin_rot[0] + x
    northing = model.origin_rot[1] + y
    z_asl = (np.arange(k0, nz) + 0.5) * sp - base_h + terrain_min_asl

    out_fields = {}
    uname = next((k for k in fields if fields[k].ndim == 4), None)
    if uname:
        u, v, w = fields[uname][:, k0:]
        ue, vn = model.derotate_winds(u, v)
        out_fields["ue"] = ue
        out_fields["vn"] = vn
        out_fields["w"] = w
    for name, arr in fields.items():
        if arr.ndim == 3:
            out_fields[name] = arr[k0:]

    out.parent.mkdir(parents=True, exist_ok=True)
    with netcdf_file(str(out), "w") as nc:
        nc.rotate_deg_residual = float(model.rotate_deg)
        nc.terrain_min_asl_m = float(terrain_min_asl)
        nc.pedestal_height_m = float(base_h)
        nc.createDimension("easting", nx)
        nc.createDimension("northing", ny)
        nc.createDimension("z", len(z_asl))
        for dim, vals, unit in (("easting", easting, b"m"),
                                ("northing", northing, b"m"),
                                ("z", z_asl, b"m ASL")):
            var = nc.createVariable(dim, "f", (dim,))
            var[:] = np.asarray(vals, np.float32)
            var.units = unit
        for name, data in out_fields.items():
            var = nc.createVariable(name, "f", ("z", "northing", "easting"))
            var[:] = np.asarray(data, np.float32)
    return out


def _find_deck(case_dir: Path) -> Optional[Path]:
    for pat in ("conf.luw", "conf.luwdg", "conf.luwpf", "*.luw", "*.luwdg",
                "*.luwpf"):
        hits = sorted(case_dir.glob(pat))
        if hits:
            return hits[0]
    return None


def process_case(case_dir: Path, *, config: Optional[Path] = None,
                 input_subdir: Path = DEFAULT_INPUT_SUBDIR,
                 input_glob: str = DEFAULT_INPUT_GLOB,
                 output_subdir: Path = DEFAULT_OUTPUT_SUBDIR,
                 pedestal: Optional[float] = None,
                 terrain_min_asl: float = 0.0,
                 limit: Optional[int] = None,
                 overwrite: bool = False) -> List[Path]:
    """All matching VTKs of one case -> NetCDFs under output_subdir.
    Falls back to the newest RESULTS/vtk average when the cropped-input
    tree doesn't exist."""
    deck_path = config or _find_deck(case_dir)
    if deck_path is None:
        raise FileNotFoundError(f"no deck under {case_dir}")
    in_dir = case_dir / input_subdir
    vtks = sorted(in_dir.glob(input_glob)) if in_dir.is_dir() else []
    if not vtks:
        deck = load_deck(deck_path)
        dt = deck.get_text("datetime") or ""
        vtks = [f for f in discover_case_vtk_files(case_dir, dt)
                if "_avg-" in f.name][-1:]
    if limit is not None:
        vtks = vtks[:limit]
    if not vtks:
        raise FileNotFoundError(f"no averaged VTKs for {case_dir}")
    written = []
    for vtk in vtks:
        p = convert(deck_path, vtk, pedestal=pedestal,
                    terrain_min_asl=terrain_min_asl,
                    out_dir=case_dir / output_subdir, overwrite=overwrite)
        if p is not None:
            written.append(p)
            print(f"luwutmnc: wrote {p.relative_to(case_dir)}")
    return written


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="luwutmnc",
        description="Convert averaged VTKs to NetCDF on true UTM "
                    "easting/northing with ASL heights (reference "
                    "vtk_avg_to_utm_asl_nc.py CLI).")
    parser.add_argument("root", help="a deck file (single case) or a "
                        "multi-case root directory used with --cases")
    parser.add_argument("--case-dir", default=None,
                        help="process one case directory")
    parser.add_argument("--config", default=None,
                        help="explicit deck path for --case-dir mode")
    parser.add_argument("--cases", nargs="*", default=None,
                        help="case subdirectory names under the root")
    parser.add_argument("--range-file", default=None,
                        help="Range.txt with per-case terrain ASL values")
    parser.add_argument("--terrain-min-asl", type=float, default=None,
                        help="terrain minimum true ASL in meters")
    parser.add_argument("--input-subdir", default=str(DEFAULT_INPUT_SUBDIR))
    parser.add_argument("--input-glob", default=DEFAULT_INPUT_GLOB)
    parser.add_argument("--output-subdir", default=str(DEFAULT_OUTPUT_SUBDIR))
    parser.add_argument("--pedestal-height", type=float, default=None,
                        help="pedestal/base rows to remove in meters "
                             "(default: deck base_height or 50)")
    parser.add_argument("--compression-level", type=int, default=3,
                        help="accepted for reference-CLI compatibility; "
                             "the NetCDF-3 writer has no zlib")
    parser.add_argument("--limit", type=int, default=None,
                        help="limit files per case (testing)")
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    if args.compression_level not in (0, 3):
        print("luwutmnc: note: --compression-level ignored "
              "(NetCDF-3 writer)")

    root = Path(args.root).expanduser().resolve()
    kwargs = dict(input_subdir=Path(args.input_subdir),
                  input_glob=args.input_glob,
                  output_subdir=Path(args.output_subdir),
                  pedestal=args.pedestal_height, limit=args.limit,
                  overwrite=args.overwrite)

    try:
        if args.case_dir:
            case = Path(args.case_dir).expanduser().resolve()
            asl = args.terrain_min_asl or 0.0
            if args.range_file:
                vals = parse_range_asl(Path(args.range_file), [case.name])
                asl = vals.get(case.name.lower(), asl)
            written = process_case(
                case, config=Path(args.config) if args.config else None,
                terrain_min_asl=asl, **kwargs)
        elif args.cases:
            if not root.is_dir():
                print(f"luwutmnc: ERROR: {root} is not a case root")
                return 1
            asl_map: Dict[str, float] = {}
            if args.range_file:
                asl_map = parse_range_asl(Path(args.range_file), args.cases)
            written = []
            for name in args.cases:
                case = root / name
                if not case.is_dir():
                    print(f"luwutmnc: WARNING: missing case {name}")
                    continue
                asl = asl_map.get(name.lower(),
                                  args.terrain_min_asl or 0.0)
                written += process_case(case, terrain_min_asl=asl, **kwargs)
        else:   # single deck (legacy single-argument form)
            deck_path = root
            if deck_path.is_dir():
                print("luwutmnc: ERROR: pass a deck file, or use --cases/"
                      "--case-dir for directories")
                return 2
            asl = args.terrain_min_asl or 0.0
            if args.range_file:
                vals = parse_range_asl(Path(args.range_file),
                                       [deck_path.parent.name])
                asl = vals.get(deck_path.parent.name.lower(), asl)
            written = process_case(deck_path.parent, config=deck_path,
                                   terrain_min_asl=asl, **kwargs)
    except (FileNotFoundError, ValueError) as e:
        print(f"luwutmnc: ERROR: {e}")
        return 1
    if not written:
        print("luwutmnc: nothing written")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
