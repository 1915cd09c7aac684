"""vtk2nc — solver VTK output -> geographic NetCDF.

Clean-room equivalent of tools_core/vtk2nc_new.py: discover the case's VTK
files, parse the binary STRUCTURED_POINTS, derive the largest fully-covered
lon/lat rectangle of the rotated-UTM grid at native resolution, cubic-regrid
every level through the inverse transform (winds de-rotated to east/north),
and write NetCDF into RESULTS/.  NetCDF written as classic NetCDF-3 via scipy (no netCDF4
dependency needed).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..deck import load_deck
from ..io.vtk import read_structured_points
from .transform import TransformModel


def discover_case_vtk_files(home: Path, datetime_tag: str) -> List[Path]:
    vtk_dir = home / "RESULTS" / "vtk"
    if not vtk_dir.exists():
        return []
    return sorted(p for p in vtk_dir.glob(f"*{datetime_tag}*.vtk"))


class LonLatRegridder:
    """Cubic regrid of rotated-local-grid planes onto a regular lon/lat grid.

    Built once per VTK file, applied to every field: the target lon/lat
    axes cover the largest axis-aligned rectangle fully inside the rotated
    source quadrilateral (so the product has no extrapolated fringe), at
    the source grid's own resolution, and each target point carries its
    fractional source index from the INVERSE transform — fields then
    interpolate per level with a cubic spline (parity with the reference's
    map_coordinates path, vtk2nc_new.py:588-660 bounds, :745-764 cubic).
    """

    def __init__(self, lon_t, lat_t, y_idx, x_idx):
        self.lon = lon_t
        self.lat = lat_t
        self._coords = np.vstack([y_idx.ravel(), x_idx.ravel()])
        self._out_shape = (len(lat_t), len(lon_t))

    @classmethod
    def build(cls, model, x, y) -> "LonLatRegridder":
        nx, ny = len(x), len(y)

        # largest complete rectangle: along each pair of opposite edges,
        # the binding bound is the innermost edge value
        lon_w, _ = model.local_to_lonlat(np.full(ny, x[0]), y)
        lon_e, _ = model.local_to_lonlat(np.full(ny, x[-1]), y)
        _, lat_s = model.local_to_lonlat(x, np.full(nx, y[0]))
        _, lat_n = model.local_to_lonlat(x, np.full(nx, y[-1]))
        lon_lo = float(np.max(np.minimum(lon_w, lon_e)))
        lon_hi = float(np.min(np.maximum(lon_w, lon_e)))
        lat_lo = float(np.max(np.minimum(lat_s, lat_n)))
        lat_hi = float(np.min(np.maximum(lat_s, lat_n)))
        if not (np.isfinite([lon_lo, lon_hi, lat_lo, lat_hi]).all()
                and lon_hi > lon_lo and lat_hi > lat_lo):
            raise ValueError("degenerate complete lon/lat coverage rectangle")

        # native angular resolution from the mid row / mid column
        lon_mid, _ = model.local_to_lonlat(x, np.full(nx, y[ny // 2]))
        _, lat_mid = model.local_to_lonlat(np.full(ny, x[nx // 2]), y)
        dlon = float(np.median(np.abs(np.diff(lon_mid)))) or (
            (lon_hi - lon_lo) / max(nx - 1, 1))
        dlat = float(np.median(np.abs(np.diff(lat_mid)))) or (
            (lat_hi - lat_lo) / max(ny - 1, 1))

        sx = float(x[1] - x[0]) if nx > 1 else 1.0
        sy = float(y[1] - y[0]) if ny > 1 else 1.0
        bounds = [lon_lo, lon_hi, lat_lo, lat_hi]
        for _ in range(12):
            b_lon_lo, b_lon_hi, b_lat_lo, b_lat_hi = bounds
            n_lon = min(max(2, int(round((b_lon_hi - b_lon_lo) / dlon)) + 1),
                        4 * nx)
            n_lat = min(max(2, int(round((b_lat_hi - b_lat_lo) / dlat)) + 1),
                        4 * ny)
            lon_t = np.linspace(b_lon_lo, b_lon_hi, n_lon)
            lat_t = np.linspace(b_lat_lo, b_lat_hi, n_lat)
            glon, glat = np.meshgrid(lon_t, lat_t)
            lx, ly = model.lonlat_to_local(glon, glat)
            x_idx = (lx - x[0]) / sx
            y_idx = (ly - y[0]) / sy
            tol = 1e-6
            inside = ((x_idx >= -tol) & (x_idx <= nx - 1 + tol)
                      & (y_idx >= -tol) & (y_idx <= ny - 1 + tol))
            if inside.all():
                return cls(lon_t, lat_t,
                           np.clip(y_idx, 0.0, ny - 1),
                           np.clip(x_idx, 0.0, nx - 1))
            # round-trip transform error pushed points out: shrink and retry
            bounds = [b_lon_lo + 2 * dlon, b_lon_hi - 2 * dlon,
                      b_lat_lo + 2 * dlat, b_lat_hi - 2 * dlat]
            if bounds[1] <= bounds[0] or bounds[3] <= bounds[2]:
                break
        raise ValueError("could not fit a fully-covered lon/lat target grid")

    def __call__(self, values: np.ndarray) -> np.ndarray:
        """(Z, ny, nx) -> (Z, nlat, nlon), per-level cubic spline."""
        from scipy.ndimage import map_coordinates

        out = np.empty((values.shape[0], *self._out_shape), np.float32)
        for k in range(values.shape[0]):
            out[k] = map_coordinates(
                np.asarray(values[k], np.float32), self._coords,
                order=3, mode="nearest").reshape(self._out_shape)
        return out


class _IdentityModel:
    """Geography-free decks export on the local meter grid unchanged."""

    def local_to_lonlat(self, x, y):
        return np.asarray(x, np.float64), np.asarray(y, np.float64)

    def lonlat_to_local(self, lon, lat):
        return np.asarray(lon, np.float64), np.asarray(lat, np.float64)


def write_netcdf(path: Path, lon, lat, z, fields: dict) -> Path:
    from scipy.io import netcdf_file

    path.parent.mkdir(parents=True, exist_ok=True)
    with netcdf_file(str(path), "w") as nc:
        nc.createDimension("lon", len(lon))
        nc.createDimension("lat", len(lat))
        nc.createDimension("z", len(z))
        vlon = nc.createVariable("lon", "f", ("lon",))
        vlat = nc.createVariable("lat", "f", ("lat",))
        vz = nc.createVariable("z", "f", ("z",))
        vlon[:] = np.asarray(lon, np.float32)
        vlat[:] = np.asarray(lat, np.float32)
        vz[:] = np.asarray(z, np.float32)
        vlon.units = b"degrees_east"
        vlat.units = b"degrees_north"
        vz.units = b"m"
        for name, data in fields.items():
            var = nc.createVariable(name, "f", ("z", "lat", "lon"))
            var[:] = np.asarray(data, np.float32)
            var.units = b"m s-1" if name in ("u", "v", "w", "ue", "vn") else b""
    return path


def convert_vtk_to_nc(deck_path: Path, vtk_path: Path) -> Optional[Path]:
    deck = load_deck(deck_path)
    meta, fields = read_structured_points(vtk_path)
    nx, ny, nz = meta["dims"]
    sp = meta["spacing"][0]
    origin = meta["origin"]

    # local cell-center coordinates spanning [0, N*sp]
    x = (np.arange(nx) + 0.5) * sp
    y = (np.arange(ny) + 0.5) * sp
    z = origin[2] + np.arange(nz) * sp

    if deck.get_pair("cut_lon_manual") and deck.get_pair("cut_lat_manual"):
        model = TransformModel.from_deck(deck, (nx * sp, ny * sp))
        derotate = model.derotate_winds
    else:
        # geography-free decks (profile/dataset-gen modes): export on the
        # local meter grid with an identity wind transform
        model = _IdentityModel()

        def derotate(u, v):
            return u, v
    regrid = LonLatRegridder.build(model, x, y)

    out_fields = {}
    uname = next((k for k in fields
                  if k.lower().startswith("u") or fields[k].ndim == 4), None)
    if uname and fields[uname].ndim == 4:
        u, v, w = fields[uname]
        ue, vn = derotate(u, v)
        out_fields["ue"] = regrid(ue)
        out_fields["vn"] = regrid(vn)
        out_fields["w"] = regrid(w)
    for name, arr in fields.items():
        if arr.ndim == 3 and name.lower() not in ("fluid",):
            out_fields[name] = regrid(arr)
    if not out_fields:
        return None
    out = vtk_path.parent.parent / (vtk_path.stem + ".nc")
    return write_netcdf(out, regrid.lon, regrid.lat, z, out_fields)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: vtk2nc <deck file>")
        return 2
    deck_path = Path(argv[0]).expanduser().resolve()
    deck = load_deck(deck_path)
    dt = deck.get_text("datetime") or ""
    files = discover_case_vtk_files(deck_path.parent, dt)
    if not files:
        print(f"vtk2nc: no VTK files found for datetime {dt}")
        return 1
    written = 0
    for f in files:
        try:
            out = convert_vtk_to_nc(deck_path, f)
        except Exception as e:
            print(f"vtk2nc: {f.name}: {type(e).__name__}: {e}")
            continue
        if out is not None:
            print(f"vtk2nc: {f.name} -> {out.name}")
            written += 1
    print(f"vtk2nc: wrote {written} NetCDF file(s)")
    return 0 if written else 1


if __name__ == "__main__":
    sys.exit(main())
