"""visdem / shptester — DEM visualizer and shapefile validity audit.

Counterpart of `latticeurbanwind_tpu/cli/dem_shp_tools.py` (host numpy).

visdem (reference: tools_core/visdem.py): a three-view DEM figure through
`io/figure.py` — the hillshade (sun at azimuth 315, altitude 45, vertical
exaggeration 2, as matplotlib's LightSource draws it), the elevation in 24
bands, and the banded elevation shaded by the hillshade (the port draws no
3-D surface; the panel titles go in the PNG's text chunk).  It reads the
pipeline's own `interpolated_dem.csv` (x,y,z rows on a regular grid), and
a GeoTIFF when rasterio imports.

shptester (reference: tools_core/shpTester.py): per-record degenerate-
geometry audit of a polygon shapefile with a defect histogram.  Uses
geopandas and shapely's explain_validity when they import; otherwise the
pure-python checks in pre/shp_reader.py (null/empty/too-few-points/open
ring/zero area).

    python -m latticeurbanwind_tpu_torch.cli.dispatch visdem proj_temp/interpolated_dem.csv dem.png
    python -m latticeurbanwind_tpu_torch.cli.dispatch shptester building_db/buildings.shp
"""

from __future__ import annotations

import sys
from collections import Counter
from pathlib import Path

import numpy as np

from ..io.figure import Figure, panel_size
from ..run.fieldvis import colorscale_rainbow


# --------------------------------------------------------------------------
# visdem
# --------------------------------------------------------------------------

def _load_dem_csv(path: Path):
    """interpolated_dem.csv: x,y,z regular grid -> (X2d, Y2d, Z2d)."""
    arr = np.loadtxt(path, delimiter=",", skiprows=1)
    xs = np.unique(arr[:, 0])
    ys = np.unique(arr[:, 1])
    z = np.full((len(ys), len(xs)), np.nan)
    xi = np.searchsorted(xs, arr[:, 0])
    yi = np.searchsorted(ys, arr[:, 1])
    z[yi, xi] = arr[:, 2]
    return np.meshgrid(xs, ys), z


def _load_dem_tif(path: Path):
    import rasterio  # optional; absent in this image

    with rasterio.open(path) as src:
        z = src.read(1).astype(np.float64)
        if src.nodata is not None:
            z = np.where(z == src.nodata, np.nan, z)
        z = np.where(z == -9999, np.nan, z)
        h, w = z.shape
        xs = np.arange(w) * src.res[0] + src.bounds.left
        ys = src.bounds.top - np.arange(h) * src.res[1]
        print(f"CRS: {src.crs}  bounds: {src.bounds}  res: {src.res}")
    return np.meshgrid(xs, ys), z


def hillshade(z: np.ndarray, *, azdeg: float = 315.0, altdeg: float = 45.0,
              vert_exag: float = 1.0) -> np.ndarray:
    """Illumination in [0, 1] of a (rows, cols) elevation grid, row 0 at
    the top, by matplotlib's `LightSource.hillshade` formula (unit cell
    spacing, the intensity stretched to its full range)."""
    az = np.radians(90.0 - azdeg)
    alt = np.radians(altdeg)
    dy, dx = np.gradient(vert_exag * np.asarray(z, np.float64))
    dy = -dy
    normal = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    light = np.array([np.cos(az) * np.cos(alt), np.sin(az) * np.cos(alt),
                      np.sin(alt)])
    intensity = normal @ light
    lo, hi = intensity.min(), intensity.max()
    return (intensity - lo) / (hi - lo) if hi > lo else np.clip(intensity, 0, 1)


def visdem_main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: visdem <dem.tif | interpolated_dem.csv | case dir> [out.png]")
        return 2
    path = Path(argv[0])
    if path.is_dir():
        cand = path / "proj_temp" / "interpolated_dem.csv"
        if not cand.exists():
            cand = path / "interpolated_dem.csv"
        path = cand
    if not path.exists():
        print(f"visdem: {path} not found")
        return 1
    print(f"Loading DEM: {path}")
    if path.suffix.lower() in (".tif", ".tiff"):
        try:
            (X, Y), Z = _load_dem_tif(path)
        except ImportError:
            print("visdem: rasterio not installed — convert to CSV via luwvox, "
                  "or install rasterio for GeoTIFF input")
            return 1
    else:
        (X, Y), Z = _load_dem_csv(path)

    finite = np.isfinite(Z)
    print(f"grid: {Z.shape[1]} x {Z.shape[0]}  "
          f"z range: {np.nanmin(Z):.2f}..{np.nanmax(Z):.2f} m  "
          f"({100.0 * finite.mean():.1f}% valid)")

    Zf = np.where(finite, Z, np.nanmean(Z))
    shade = hillshade(Zf, vert_exag=2.0)
    lo, hi = float(Zf.min()), float(Zf.max())
    bands = np.floor((Zf - lo) / max(hi - lo, 1e-12) * 24).clip(0, 23) / 23.0
    bands = np.where(finite, bands, np.nan)
    fig = Figure(1, 3, panel_size(Z.shape[1], Z.shape[0], 400),
                 title=f"{path.name}")
    ext = (float(X.min()), float(X.max()), float(Y.min()), float(Y.max()))
    fig.panels[0].image(shade, scale="gray", vmin=0.0, vmax=1.0, extent=ext)
    fig.panels[0].title = "hillshade"
    fig.panels[1].image(bands, scale="rainbow", vmin=0.0, vmax=1.0, extent=ext)
    fig.panels[1].title = f"elevation in 24 bands, {lo:.2f}..{hi:.2f} m"
    relief = colorscale_rainbow(np.nan_to_num(bands)) * (0.35 + 0.65 * shade)[..., None]
    fig.panels[2].image(relief, extent=ext)
    fig.panels[2].title = "shaded relief"
    out = fig.save(Path(argv[1]) if len(argv) > 1 else path.with_suffix(".png"))
    print(f"wrote {out}")
    return 0


# --------------------------------------------------------------------------
# shptester
# --------------------------------------------------------------------------

def _shptester_geopandas(path: Path) -> int:
    import geopandas as gpd
    from shapely.validation import explain_validity

    gdf = gpd.read_file(path)
    counts: Counter = Counter()
    bad = []
    for idx, geom in enumerate(gdf.geometry):
        if geom is None or geom.is_empty:
            counts["null_or_empty"] += 1
            bad.append((idx, "null_or_empty"))
        elif not geom.is_valid:
            reason = explain_validity(geom)
            counts["invalid"] += 1
            bad.append((idx, reason))
        elif geom.area <= 0:
            counts["zero_area"] += 1
            bad.append((idx, "zero_area"))
        else:
            counts["ok"] += 1
    _report(len(gdf), counts, bad)
    return 0 if counts["ok"] == len(gdf) else 1


def _shptester_pure(path: Path) -> int:
    from ..pre.shp_reader import polygon_defects, read_shp

    shp = read_shp(path)
    print(f"shape type: {shp.shape_name}  records: {len(shp.records)}  "
          f"bbox: {tuple(round(v, 3) for v in shp.bbox)}")
    counts: Counter = Counter()
    bad = []
    for rec in shp.records:
        issues = polygon_defects(rec)
        if issues:
            counts.update(i.split(":")[-1] for i in issues)
            bad.append((rec.number, ";".join(issues)))
        else:
            counts["ok"] += 1
    _report(len(shp.records), counts, bad)
    return 0 if counts["ok"] == len(shp.records) else 1


def _report(total: int, counts: Counter, bad) -> None:
    print(f"records: {total}")
    for key, n in counts.most_common():
        print(f"  {key:<18s} {n}")
    for idx, reason in bad[:20]:
        print(f"  record {idx}: {reason}")
    if len(bad) > 20:
        print(f"  ... and {len(bad) - 20} more")


def shptester_main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: shptester <file.shp | case dir>")
        return 2
    path = Path(argv[0])
    if path.is_dir():
        cands = sorted((path / "building_db").glob("*.shp")) or sorted(path.glob("*.shp"))
        if not cands:
            print(f"shptester: no .shp under {path}")
            return 1
        path = cands[0]
    print(f"Testing shapefile: {path}")
    try:
        return _shptester_geopandas(path)
    except ImportError:
        return _shptester_pure(path)
