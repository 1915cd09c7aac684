"""visluw — per-height wind-section figures + NetCDF export from the case VTK.

Counterpart of `latticeurbanwind_tpu/post/visluw.py` (host numpy; the
spec of tools_core/visluw.py:1-30):
  * ground definition: the slab [zmin, zmin + base_height) is the base
    pedestal; real height is h = z_vtk - (zmin + base_height);
  * `--sections N` height layers (default 9), or `--heights 10,30,60` in
    meters above the base;
  * one figure per selected layer as wind_<height>m.png under
    RESULTS/sections: the horizontal speed (rainbow) with arrows, on the
    layer's lon/lat extent, drawn through `io/figure.py` (no colour bar,
    the title in the PNG's text chunk);
  * vector-field priority U, velocity, Velocity, UVW, data, Data, then the
    first 3-component array; data_rho ignored;
  * the 3-D NetCDF in lon/lat coordinates, RESULTS/<vtk stem>_visluw.nc
    (on unless --no-nc), byte for byte as the JAX package writes it.

    python -m latticeurbanwind_tpu_torch.cli.dispatch visluw conf.luw
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..deck import load_deck
from ..io.figure import Figure, panel_size
from ..io.vtk import read_structured_points
from .transform import TransformModel
from .vtk2nc import discover_case_vtk_files

_FIELD_PRIORITY = ("U", "velocity", "Velocity", "UVW", "data", "Data")


def pick_vector_field(fields: dict):
    """(name, (u, v, w)) by the reference's priority list."""
    for name in _FIELD_PRIORITY:
        if name in fields and fields[name].ndim == 4:
            return name, fields[name]
    for name, arr in fields.items():
        if name.lower() == "data_rho":
            continue
        if arr.ndim == 4 and arr.shape[0] == 3:
            return name, arr
    raise ValueError("no 3-component vector field found")


def _geo_grid(deck, nx, ny, sp):
    try:
        model = TransformModel.from_deck(deck, (nx * sp, ny * sp))
        x = (np.arange(nx) + 0.5) * sp
        y = (np.arange(ny) + 0.5) * sp
        gx, gy = np.meshgrid(x, y)
        lon, lat = model.local_to_lonlat(gx, gy)
        return lon, lat, True
    except (ValueError, Exception):
        lon, lat = np.meshgrid((np.arange(nx) + 0.5) * sp,
                               (np.arange(ny) + 0.5) * sp)
        return lon, lat, False


def select_layers(nz: int, sp: float, z0: float, base_h: float,
                  *, sections: int = 9, heights=None):
    """[(k, height_m_agl)] — layer indices above the base pedestal."""
    zk = z0 + (np.arange(nz) + 0.5) * sp        # layer-center absolute z
    h = zk - (z0 + base_h)                      # real height above pedestal
    above = np.nonzero(h >= 0.0)[0]
    if len(above) == 0:
        above = np.arange(nz)
        h = zk - z0
    if heights:
        out = []
        for target in heights:
            k = int(above[np.argmin(np.abs(h[above] - target))])
            out.append((k, float(h[k])))
        # drop duplicate layers while preserving order
        seen = set()
        return [t for t in out if not (t[0] in seen or seen.add(t[0]))]
    n = max(1, min(sections, len(above)))
    picks = np.unique(np.linspace(0, len(above) - 1, n).astype(int))
    return [(int(above[i]), float(h[above[i]])) for i in picks]


def export_netcdf(out_path: Path, lon, lat, heights_m, u, v, w,
                  extra: dict) -> Path:
    """3-D lon/lat NetCDF of the full field (reference spec item 8)."""
    from scipy.io import netcdf_file

    out_path.parent.mkdir(parents=True, exist_ok=True)
    nz, ny, nx = u.shape
    with netcdf_file(str(out_path), "w") as nc:
        nc.createDimension("height", nz)
        nc.createDimension("lat", ny)
        nc.createDimension("lon", nx)
        vh = nc.createVariable("height", "f", ("height",))
        vh[:] = np.asarray(heights_m, np.float32)
        vh.units = b"m"
        vlon = nc.createVariable("lon", "f", ("height", "lat", "lon")
                                 if np.ndim(lon) == 3 else ("lat", "lon"))
        vlat = nc.createVariable("lat", "f", ("lat", "lon"))
        vlon[:] = np.asarray(lon, np.float32)
        vlat[:] = np.asarray(lat, np.float32)
        vlon.units = b"degrees_east"
        vlat.units = b"degrees_north"
        for name, arr in (("u", u), ("v", v), ("w", w), *extra.items()):
            var = nc.createVariable(name, "f", ("height", "lat", "lon"))
            var[:] = np.asarray(arr, np.float32)
            var.units = b"m s-1" if name in ("u", "v", "w") else b""
    return out_path


def render_layers(deck_path: Path, vtk_path: Path, *, layers=None,
                  sections: int = 9, heights=None, out_dir: Path = None,
                  write_nc: bool = True, nc_path: Path = None,
                  crop_lonlat=None) -> list:
    deck = load_deck(deck_path)
    meta, fields = read_structured_points(vtk_path)
    nx, ny, nz = meta["dims"]
    sp = meta["spacing"][0]
    z0 = meta["origin"][2]
    uname, vec = pick_vector_field(fields)
    u, v, w = vec
    lon, lat, geographic = _geo_grid(deck, nx, ny, sp)

    if crop_lonlat is not None:
        # reference --lon-min/--lon-max/--lat-min/--lat-max window
        # (visluw.py:677-680): clip to grid columns/rows inside the box
        lo_lon, hi_lon, lo_lat, hi_lat = crop_lonlat
        inside = ((lon >= lo_lon) & (lon <= hi_lon)
                  & (lat >= lo_lat) & (lat <= hi_lat))
        if not inside.any():
            raise ValueError("visluw: crop window misses the domain")
        jj, ii = np.nonzero(inside)
        j0, j1 = int(jj.min()), int(jj.max()) + 1
        i0, i1 = int(ii.min()), int(ii.max()) + 1
        lon, lat = lon[j0:j1, i0:i1], lat[j0:j1, i0:i1]
        u, v, w = u[:, j0:j1, i0:i1], v[:, j0:j1, i0:i1], w[:, j0:j1, i0:i1]
        fields = {k: a[..., j0:j1, i0:i1] for k, a in fields.items()}
        ny, nx = lat.shape

    base_h = deck.get_float("base_height", 50.0) or 50.0
    if layers is not None:                    # explicit indices (tests)
        chosen = [(int(k), (k + 0.5) * sp - base_h) for k in layers]
    else:
        chosen = select_layers(nz, sp, z0, base_h,
                               sections=sections, heights=heights)

    out_dir = out_dir or (deck_path.parent / "RESULTS" / "sections")
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    step = max(1, nx // 24)
    extent = (float(lon.min()), float(lon.max()), float(lat.min()), float(lat.max()))
    for k, h_m in chosen:
        speed = np.hypot(u[k], v[k])
        fig = Figure(1, 1, panel_size(nx, ny, 640),
                     title=f"{vtk_path.stem} | {h_m:.0f} m above base")
        ax = fig.panels[0]
        ax.image(speed, scale="rainbow", extent=extent)
        ax.arrows(lon[::step, ::step], lat[::step, ::step],
                  u[k, ::step, ::step], v[k, ::step, ::step])
        ax.title = ("lon/lat" if geographic else "x/y (m)") + ", wind speed (m/s)"
        written.append(fig.save(out_dir / f"wind_{h_m:.0f}m.png"))

    if write_nc:
        heights_m = z0 + (np.arange(nz) + 0.5) * sp - (z0 + base_h)
        extra = {n: a for n, a in fields.items()
                 if a.ndim == 3 and n.lower() not in ("fluid", "data_rho")}
        nc_out = nc_path or (
            deck_path.parent / "RESULTS" / f"{vtk_path.stem}_visluw.nc")
        written.append(export_netcdf(nc_out, lon, lat, heights_m, u, v, w, extra))
        print(f"visluw: NetCDF export -> {nc_out.name}")
    return written


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="visluw")
    ap.add_argument("deck")
    ap.add_argument("--sections", "--layers", dest="sections", type=int,
                    default=9,
                    help="number of height layers to export (default 9; "
                         "--layers is the reference alias)")
    ap.add_argument("--heights", type=str, default=None,
                    help="explicit section heights in m above base, comma-sep")
    ap.add_argument("--no-nc", action="store_true",
                    help="skip the 3-D NetCDF export")
    ap.add_argument("--nc-output", default=None,
                    help="NetCDF output path (reference --nc-output)")
    ap.add_argument("--output-dir", default=None,
                    help="section-figure directory (default RESULTS/sections)")
    ap.add_argument("--lon-min", type=float, default=None)
    ap.add_argument("--lon-max", type=float, default=None)
    ap.add_argument("--lat-min", type=float, default=None)
    ap.add_argument("--lat-max", type=float, default=None)
    args = ap.parse_args(list(sys.argv[1:] if argv is None else argv))

    deck_path = Path(args.deck).expanduser().resolve()
    deck = load_deck(deck_path)
    dt = deck.get_text("datetime") or ""
    files = discover_case_vtk_files(deck_path.parent, dt)
    preferred = [f for f in files if "_avg-" in f.name] or \
        [f for f in files if "_raw_u-" in f.name]
    if not preferred:
        print(f"visluw: no suitable VTK for datetime {dt}")
        return 1
    heights = ([float(h) for h in args.heights.split(",")]
               if args.heights else None)
    crop = None
    crop_vals = (args.lon_min, args.lon_max, args.lat_min, args.lat_max)
    if all(v is not None for v in crop_vals):
        crop = crop_vals
    elif any(v is not None for v in crop_vals):
        print("visluw: need all four of --lon-min/--lon-max/--lat-min/--lat-max")
        return 2
    written = render_layers(deck_path, preferred[-1], sections=args.sections,
                            heights=heights, write_nc=not args.no_nc,
                            nc_path=Path(args.nc_output)
                            if args.nc_output else None,
                            out_dir=Path(args.output_dir)
                            if args.output_dir else None,
                            crop_lonlat=crop)
    figs = sum(1 for p in written if p.suffix == ".png")
    print(f"visluw: wrote {figs} figure(s) to RESULTS/sections")
    return 0


if __name__ == "__main__":
    sys.exit(main())
