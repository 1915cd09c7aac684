"""DEM ingestion: elevation source -> proj_temp/dem_points.csv.

Analog of the reference's dem_tif_to_shp stage (bridge_core/
dem_tif_to_shp.py:1-463): load a DEM GeoTIFF from `database/`, clip to
120 % of the deck's lon/lat bounding box, and emit the per-point elevation
set the terrain interpolator consumes.  Differences from the reference:

  * outputs BOTH documented artifacts: the point shapefile
    `terrain_db/dem_points.shp` (lon/lat with an `elevation` attribute —
    the reference's drop-folder contract, dem_tif_to_shp.py:207, consumed
    by buildBC's terrain stage) and `proj_temp/dem_points.csv`
    (x, y, elevation in case-local metres — the contract
    pre/voxelization.py reads).
  * GeoTIFF input needs rasterio (absent in this image — gated with a
    clear message).  CSV/XYZ input (`lon,lat,elev` or `x,y,elev` headers)
    is always available, including point sets exported by GIS tools.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..deck import load_deck
from .utm import lonlat_to_utm, utm_zone_for

CLIP_EXPAND = 1.2   # 120 % bbox, reference dem_tif_to_shp clip margin


def _deck_bbox(deck) -> Optional[Tuple[float, float, float, float]]:
    lon = deck.get_float_list("manual_lon") or deck.get_float_list("lon_range")
    lat = deck.get_float_list("manual_lat") or deck.get_float_list("lat_range")
    if lon and lat and len(lon) == 2 and len(lat) == 2:
        return min(lon), max(lon), min(lat), max(lat)
    return None


def _expand(bbox, factor):
    lo_x, hi_x, lo_y, hi_y = bbox
    cx, cy = 0.5 * (lo_x + hi_x), 0.5 * (lo_y + hi_y)
    hx, hy = 0.5 * (hi_x - lo_x) * factor, 0.5 * (hi_y - lo_y) * factor
    return cx - hx, cx + hx, cy - hy, cy + hy


def load_dem_tif(path: Path):
    """GeoTIFF -> (lon, lat, elev) 1-D arrays (rasterio-gated)."""
    import rasterio
    from rasterio.warp import transform as rio_transform

    with rasterio.open(path) as src:
        z = src.read(1).astype(np.float64)
        nodata = src.nodata if src.nodata is not None else -9999
        h, w = z.shape
        cols, rows = np.meshgrid(np.arange(w), np.arange(h))
        xs, ys = rasterio.transform.xy(src.transform, rows.ravel(), cols.ravel())
        xs, ys = np.asarray(xs), np.asarray(ys)
        if src.crs and src.crs.to_epsg() != 4326:
            xs, ys = (np.asarray(v) for v in rio_transform(
                src.crs, "EPSG:4326", xs.tolist(), ys.tolist()))
        zf = z.ravel()
        ok = np.isfinite(zf) & (zf != nodata) & (zf != -9999)
        return xs[ok], ys[ok], zf[ok]


def load_dem_csv(path: Path):
    """CSV with lon,lat,elev / x,y,elev / x,y,z headers (or 3 bare columns)."""
    with open(path) as f:
        first = f.readline()
    has_header = any(c.isalpha() for c in first)
    arr = np.loadtxt(path, delimiter=",", skiprows=1 if has_header else 0)
    if arr.ndim != 2 or arr.shape[1] < 3:
        raise ValueError(f"{path}: expected 3 columns (lon/x, lat/y, elev)")
    geographic = has_header and ("lon" in first.lower())
    return arr[:, 0], arr[:, 1], arr[:, 2], geographic


def find_dem_source(home: Path) -> Optional[Path]:
    """Search order: database/ then proj_temp/ for TIFF/CSV/XYZ DEMs."""
    for d in (home / "database", home / "proj_temp", home):
        if not d.is_dir():
            continue
        for pat in ("*.tif", "*.tiff", "*dem*.csv", "*dem*.xyz"):
            hits = sorted(d.glob(pat))
            hits = [h for h in hits if h.name not in
                    ("interpolated_dem.csv", "dem_points.csv")]
            if hits:
                return hits[0]
    return None


def ingest_dem(deck_path: Path | str, src: Optional[Path] = None,
               quiet: bool = False) -> Optional[Path]:
    deck_path = Path(deck_path)
    home = deck_path.parent
    deck = load_deck(deck_path)
    src = src or find_dem_source(home)
    if src is None:
        if not quiet:
            print("dem_ingest: no DEM source found (database/*.tif|*dem*.csv)")
        return None

    if src.suffix.lower() in (".tif", ".tiff"):
        try:
            lon, lat, elev = load_dem_tif(src)
        except ImportError:
            print("dem_ingest: rasterio not installed — export the DEM to "
                  "CSV (lon,lat,elev) and re-run")
            return None
        geographic = True
    else:
        lon, lat, elev, geographic = load_dem_csv(src)

    bbox = _deck_bbox(deck)
    if geographic:
        if bbox is not None:
            lo_x, hi_x, lo_y, hi_y = _expand(bbox, CLIP_EXPAND)
            keep = (lon >= lo_x) & (lon <= hi_x) & (lat >= lo_y) & (lat <= hi_y)
            lon, lat, elev = lon[keep], lat[keep], elev[keep]
        if lon.size == 0:
            print("dem_ingest: no DEM points inside the case bbox")
            return None
        # the documented drop-folder artifact: a lon/lat point shapefile
        # with an elevation attribute (reference dem_tif_to_shp.py:207)
        from .shp_reader import write_point_shp

        shp_out = home / "terrain_db" / "dem_points.shp"
        shp_out.parent.mkdir(parents=True, exist_ok=True)
        write_point_shp(shp_out, np.stack([lon, lat], axis=1), values=elev)
        if not quiet:
            print(f"dem_ingest: point shapefile -> terrain_db/{shp_out.name}")

        zone = utm_zone_for(float(lon.mean()))
        x, y = lonlat_to_utm(lon, lat, zone)
        # local frame: relative to the SW corner, matching buildbc's frame
        x = x - x.min()
        y = y - y.min()
    else:
        x, y = lon, lat

    out = home / "proj_temp" / "dem_points.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    arr = np.column_stack([x, y, elev])
    np.savetxt(out, arr, delimiter=",", header="x,y,elevation",
               comments="", fmt="%.4f")
    if not quiet:
        print(f"dem_ingest: {src.name} -> {out.name} ({len(arr)} points, "
              f"elev {elev.min():.1f}..{elev.max():.1f} m)")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: luwdem <deck> [dem source file]")
        return 2
    src = Path(argv[1]) if len(argv) > 1 else None
    out = ingest_dem(Path(argv[0]), src)
    return 0 if out is not None else 1
