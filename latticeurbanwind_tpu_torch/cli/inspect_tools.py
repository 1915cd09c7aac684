"""cdfinspect / shpinspect — input inspectors.

NetCDF overview (dims, coordinate ranges, variables) and shapefile overview
(CRS, bounds, fields).  (reference: tools_core/cdfInspect.py, shpInspect.py)

NetCDF path: tries xarray, then netCDF4, then scipy (NetCDF-3) so basic
inspection works without the GIS stack.  Shapefile needs geopandas/fiona and
degrades to a clear message otherwise.
"""

from __future__ import annotations

import sys
from pathlib import Path


def resolve_nc_path(deck_dir: Path, deck) -> Path:
    """wind_bc/<case>_yyyymmddhhmmss.nc naming rule (README.md:109-116)."""
    case = deck.get_text("casename") or "case"
    dt = deck.get_text("datetime") or ""
    wind_bc = deck_dir / "wind_bc"
    exact = wind_bc / f"{case}_{dt}.nc"
    if exact.exists():
        return exact
    candidates = sorted(wind_bc.glob("*.nc"))
    if candidates:
        return candidates[0]
    raise FileNotFoundError(f"no NetCDF file found under {wind_bc}")


def resolve_shp_path(deck_dir: Path, deck) -> Path:
    building_db = deck_dir / "building_db"
    candidates = sorted(building_db.glob("*.shp"))
    if candidates:
        return candidates[0]
    raise FileNotFoundError(f"no shapefile found under {building_db}")


def _inspect_nc(path: Path) -> int:
    print(f"NetCDF file: {path}")
    try:
        import xarray as xr

        ds = xr.open_dataset(path)
        print(ds)
        for name in ("XLONG", "XLAT", "lon", "lat", "longitude", "latitude"):
            if name in ds:
                v = ds[name]
                print(f"  {name}: min={float(v.min()):.5f} max={float(v.max()):.5f}")
        return 0
    except ImportError:
        pass
    try:
        import netCDF4

        ds = netCDF4.Dataset(path)
        print("dimensions:", {k: len(v) for k, v in ds.dimensions.items()})
        print("variables:", list(ds.variables))
        return 0
    except ImportError:
        pass
    try:
        from scipy.io import netcdf_file

        ds = netcdf_file(str(path), "r", mmap=False)
        print("dimensions:", dict(ds.dimensions))
        print("variables:", {k: v.shape for k, v in ds.variables.items()})
        return 0
    except Exception as e:
        print(f"ERROR: no NetCDF reader available or unreadable file ({e}).")
        print("Install xarray/netCDF4 for full inspection.")
        return 1


def cdfinspect_main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: cdfinspect <deck|nc file>")
        return 2
    target = Path(argv[0]).expanduser().resolve()
    if target.suffix.lower().startswith(".luw"):
        from ..deck import load_deck

        deck = load_deck(target)
        try:
            target = resolve_nc_path(target.parent, deck)
        except FileNotFoundError as e:
            print(f"ERROR: {e}")
            return 1
    return _inspect_nc(target)


def shpinspect_main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: shpinspect <deck|shp file>")
        return 2
    target = Path(argv[0]).expanduser().resolve()
    if target.suffix.lower().startswith(".luw"):
        from ..deck import load_deck

        deck = load_deck(target)
        try:
            target = resolve_shp_path(target.parent, deck)
        except FileNotFoundError as e:
            print(f"ERROR: {e}")
            return 1
    print(f"Shapefile: {target}")
    try:
        import geopandas as gpd

        gdf = gpd.read_file(target)
        print("CRS:", gdf.crs)
        print("bounds:", list(gdf.total_bounds))
        print("features:", len(gdf))
        print("fields:", [c for c in gdf.columns if c != "geometry"])
        return 0
    except ImportError:
        print("ERROR: geopandas is not available in this environment; "
              "shapefile inspection requires the GIS stack.")
        return 1


if __name__ == "__main__":
    sys.exit(cdfinspect_main())
