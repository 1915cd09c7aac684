"""luwbc — NWP/WRF NetCDF -> SurfData boundary-sample CSV.

Clean-room equivalent of bridge_core/1_buildBC.py (2481 LoC).  Stages, in
the reference's order:

  1. bbox-coverage confirmation: when the wind input does not fully cover
     the deck's cut window, warn and ask with a 5 s auto-continue timeout
     (reference :449-558; misses under 0.1 % continue silently).
  2. UTM projection (own transverse-Mercator series, pre/utm.py) and the
     GRID-CONVERGENCE rotation: the domain rotates so the cut window's
     bottom edge (lon_min,lat_min)->(lon_max,lat_min) aligns with the X
     axis, pivoting on the projected bbox centroid (reference :999-1058,
     :1436-1476 — the config bounds override the data bounds).
  3. DEM terrain: point shapefile or CSV under terrain_db/ (falling back to
     the GeoTIFF drop-folder ingest), rotated into the domain frame and
     IDW-gridded; elevations rebased so min = 0 (reference :559-685).
  4. horizontal interpolation onto a uniform meter grid with spacing ~
     midmesh_basesize (default 50 m), vertical resample onto a uniform AGL
     ladder of the same spacing with nearest fill beyond the data range;
     pressure-looking vertical coordinates fall back to index-based meters
     (reference :1560-1700).
  5. SurfData_<datetime>.csv with the PATCH column: bottom=0 (ground+eps,
     with w), top=1 (flat cap, w=0), south=2/north=3/west=4/east=5 (ground
     point + k*dz AGL levels, w=0); values column-interpolated by the
     inverse-distance-between-bracketing-levels rule with local terrain
     uplift (reference :2119-2400).
  6. deck writebacks: si_*_cfd, utm_crs, rotate_deg, origin_shift_applied,
     um_vol (gridded volume mean), um_bc (CSV row mean), downstream_bc and
     downstream_bc_yaw (signed angle off the downstream face normal)
     (reference :1822-1826, :2413-2438).

A dependency-light path accepts proj_temp/wind_samples.csv
(lon,lat,z_agl,u,v,w[,T]) with the same projection/rotation semantics.
"""

from __future__ import annotations

import math
import os
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..deck import load_deck
from ..io.progress import ProgressEmitter
from .utm import lonlat_to_utm, utm_epsg_for, utm_zone_for

PATCH_BOTTOM, PATCH_TOP, PATCH_SOUTH, PATCH_NORTH, PATCH_WEST, PATCH_EAST = range(6)


# ---------------------------------------------------------------------------
# bbox coverage confirmation (reference :449-558)
# ---------------------------------------------------------------------------


def _bbox_max_miss_percent(target, inp) -> float:
    tl0, tl1, tt0, tt1 = target
    il0, il1, it0, it1 = inp
    span_lon = max(tl1 - tl0, 1e-12)
    span_lat = max(tt1 - tt0, 1e-12)
    misses = [
        max(0.0, il0 - tl0) / span_lon,
        max(0.0, tl1 - il1) / span_lon,
        max(0.0, it0 - tt0) / span_lat,
        max(0.0, tt1 - it1) / span_lat,
    ]
    return 100.0 * max(misses)


def confirm_bbox_coverage(kind: str, target, inp, *, timeout_s: float = 5.0) -> None:
    """Warn + timed Y/N prompt when `inp` does not cover `target`; exits on
    an explicit N.  Non-interactive runs (no TTY, or LUW_ASSUME_YES set)
    auto-continue, matching the reference's timeout default."""
    miss = _bbox_max_miss_percent(target, inp)
    if miss <= 0.0:
        return
    if miss < 0.1:
        print(f"[luwbc] WARNING: {kind} bounds slightly smaller than target "
              f"(max miss {miss:.4f}% < 0.1%). Continue without interruption.")
        return
    print(f"[luwbc] WARNING: {kind} bounds do not fully cover the target area "
          f"(max miss {miss:.2f}%).")
    print(f"[luwbc]   target lon [{target[0]:.6f}, {target[1]:.6f}] "
          f"lat [{target[2]:.6f}, {target[3]:.6f}]")
    print(f"[luwbc]   input  lon [{inp[0]:.6f}, {inp[1]:.6f}] "
          f"lat [{inp[2]:.6f}, {inp[3]:.6f}]")
    if os.environ.get("LUW_ASSUME_YES") or not sys.stdin.isatty():
        print("[luwbc] non-interactive run — continuing by default.")
        return
    try:
        import select

        sys.stdout.write(f"Continue anyway? (Y/N) [auto-continue in "
                         f"{int(timeout_s)}s]: ")
        sys.stdout.flush()
        ready, _, _ = select.select([sys.stdin], [], [], timeout_s)
        ans = sys.stdin.readline().strip().lower() if ready else None
    except Exception:
        ans = None
    if ans is None:
        print(f"\n[luwbc] no input (timeout {int(timeout_s)}s) — continuing.")
        return
    if ans in ("n", "no"):
        print("[luwbc] user canceled. Exiting.")
        sys.exit(1)
    print("[luwbc] continuing despite bounds mismatch.")


# ---------------------------------------------------------------------------
# projection / rotation (reference :999-1058)
# ---------------------------------------------------------------------------


def bbox_rotation(lon_pair, lat_pair, zone: int):
    """(rotate_deg, pivot_xy): rotation aligning the bbox bottom edge with
    the X axis (compensates UTM grid convergence), pivot = bbox centroid."""
    lons = np.array([lon_pair[0], lon_pair[1], lon_pair[1], lon_pair[0]])
    lats = np.array([lat_pair[0], lat_pair[0], lat_pair[1], lat_pair[1]])
    xs, ys = lonlat_to_utm(lons, lats, zone=zone)
    angle = math.atan2(float(ys[1] - ys[0]), float(xs[1] - xs[0]))
    rotate_deg = -math.degrees(angle)
    pivot = (float(xs.mean()), float(ys.mean()))
    corners = np.stack([xs, ys], axis=1)
    return rotate_deg, pivot, corners


def rotate_xy(x, y, deg: float, cx: float, cy: float):
    th = math.radians(deg)
    c, s = math.cos(th), math.sin(th)
    xr = c * (x - cx) - s * (y - cy) + cx
    yr = s * (x - cx) + c * (y - cy) + cy
    return xr, yr


# ---------------------------------------------------------------------------
# DEM loading (reference :559-685) + gridding
# ---------------------------------------------------------------------------


def load_dem_lonlat(home: Path, deck) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """DEM points from terrain_db/ -> (lonlat (N,2), elevation (N,)).
    Sources: point shapefile (elevation attribute), or a CSV with a
    lon,lat,elevation header.  Elevations rebased so min = 0."""
    folder = home / "terrain_db"
    if not folder.exists():
        return None
    for shp in sorted(folder.glob("*.shp")):
        try:
            from .shp_reader import read_shp

            data = read_shp(shp)
            pts = np.array([r.point for r in data.records if r.point is not None])
            if not len(pts):
                continue
            names = {f.lower(): f for f in data.fields}
            field = next((names[k] for k in names
                          if k in ("elevation", "elev", "height", "z", "dem",
                                   "grid_code", "gridcode", "value")
                          or k.startswith(("elev", "height", "alt", "dem"))),
                         None)
            if field is None and len(names) == 1:
                # a single attribute column can only be the elevation
                field = next(iter(names.values()))
            if field is None and data.fields:
                raise ValueError(
                    f"{shp.name}: no elevation-like attribute among "
                    f"{data.fields} — rename the column (elev*/height*/alt*/"
                    "z/dem) rather than risk reading ids as terrain")
            if field is None or not data.attributes:
                elev = np.zeros(len(pts))
            else:
                elev = np.array([float(a.get(field) or 0.0)
                                 for a in data.attributes[:len(pts)]])
            elev = elev - np.nanmin(elev)
            print(f"[luwbc] DEM: {shp.name}, {len(pts)} points, "
                  f"relief {float(np.nanmax(elev)):.1f} m")
            return pts, elev
        except Exception as e:
            print(f"[luwbc] WARNING: failed to read DEM {shp.name}: {e}")
    for csv in sorted(folder.glob("*.csv")):
        try:
            raw = np.loadtxt(csv, delimiter=",", skiprows=1, ndmin=2)
            if raw.shape[1] < 3:
                continue
            elev = raw[:, 2] - np.nanmin(raw[:, 2])
            print(f"[luwbc] DEM: {csv.name}, {len(raw)} points")
            return raw[:, :2], elev
        except Exception:
            continue
    return None


def _idw_grid(points_xy, values, x_grid, y_grid, *, neighbors: int = 8) -> np.ndarray:
    """Scattered points -> (ny, nx) grid by inverse-distance weighting."""
    from scipy.spatial import cKDTree

    gx, gy = np.meshgrid(x_grid, y_grid)
    q = np.stack([gx.ravel(), gy.ravel()], axis=1)
    tree = cKDTree(points_xy)
    k = min(neighbors, len(points_xy))
    dist, idx = tree.query(q, k=k)
    dist = np.atleast_2d(dist.T).T
    idx = np.atleast_2d(idx.T).T
    w = 1.0 / np.maximum(dist, 1e-6) ** 2
    out = (w * values[idx]).sum(axis=1) / w.sum(axis=1)
    return out.reshape(len(y_grid), len(x_grid))


def _interp_to_grid(vals3, src_x, src_y, x_grid, y_grid) -> np.ndarray:
    """(nz, ny_src, nx_src) on scattered/curvilinear (src_x, src_y) ->
    (nz, ny, nx) on the uniform grid (linear with nearest fill)."""
    from scipy.interpolate import griddata

    pts = np.stack([np.asarray(src_x).ravel(), np.asarray(src_y).ravel()], axis=1)
    gx, gy = np.meshgrid(x_grid, y_grid)
    out = np.empty((vals3.shape[0], len(y_grid), len(x_grid)), np.float32)
    for k in range(vals3.shape[0]):
        v = vals3[k].ravel()
        lin = griddata(pts, v, (gx, gy), method="linear")
        if np.isnan(lin).any():
            near = griddata(pts, v, (gx, gy), method="nearest")
            lin = np.where(np.isnan(lin), near, lin)
        out[k] = lin
    return out


def _idw_interp_1d(col, z_query: float, z_src) -> float:
    """Inverse-distance between the two bracketing levels (the reference's
    exact column rule, :1899-1928 — NOT linear interpolation)."""
    if z_query <= z_src[0]:
        return float(col[0])
    if z_query >= z_src[-1]:
        return float(col[-1])
    k_up = int(np.searchsorted(z_src, z_query))
    k_lo = k_up - 1
    d_lo = abs(z_query - float(z_src[k_lo]))
    d_up = abs(z_query - float(z_src[k_up]))
    if d_lo < 1e-6:
        return float(col[k_lo])
    if d_up < 1e-6:
        return float(col[k_up])
    w_lo, w_up = 1.0 / d_lo, 1.0 / d_up
    return float((w_lo * float(col[k_lo]) + w_up * float(col[k_up])) / (w_lo + w_up))


# ---------------------------------------------------------------------------
# main structured path
# ---------------------------------------------------------------------------


def build_structured(deck_path: Path, lon, lat, z_levels, u, v, w, T=None,
                     *, vert_units: str = "", vert_name: str = "") -> Path:
    """Gridded NWP fields (nz, ny, nx) + lon/lat (2-D or 1-D) -> SurfData CSV
    with the patch column, plus all deck writebacks."""
    deck = load_deck(deck_path)
    home = deck_path.parent
    progress = ProgressEmitter("luwbc")
    dt = deck.get_text("datetime") or "20990101120000"

    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    w = np.asarray(w, np.float32)
    T = None if T is None else np.asarray(T, np.float32)
    lon = np.asarray(lon, float)
    lat = np.asarray(lat, float)
    if lon.ndim == 1:
        lon, lat = np.meshgrid(lon, lat)
    nz_src = u.shape[0]

    data_bounds = (float(np.nanmin(lon)), float(np.nanmax(lon)),
                   float(np.nanmin(lat)), float(np.nanmax(lat)))
    lon_pair = deck.get_pair("cut_lon_manual")
    lat_pair = deck.get_pair("cut_lat_manual")
    if lon_pair and lat_pair:
        target = (lon_pair[0], lon_pair[1], lat_pair[0], lat_pair[1])
        confirm_bbox_coverage("Wind NC", target, data_bounds)
    else:
        lon_pair = (data_bounds[0], data_bounds[1])
        lat_pair = (data_bounds[2], data_bounds[3])

    clon = 0.5 * (lon_pair[0] + lon_pair[1])
    clat = 0.5 * (lat_pair[0] + lat_pair[1])
    zone = utm_zone_for(clon)
    epsg = utm_epsg_for(clon, clat)

    # grid-convergence rotation from the cut window's bottom edge
    progress.emit("Projecting wind grid", indeterminate=True, force=True)
    rotate_deg, pivot, corners = bbox_rotation(lon_pair, lat_pair, zone)
    xr_c, yr_c = rotate_xy(corners[:, 0], corners[:, 1], rotate_deg,
                           pivot[0], pivot[1])
    x_origin, y_origin = float(xr_c.min()), float(yr_c.min())
    si_x_range = float(xr_c.max()) - x_origin
    si_y_range = float(yr_c.max()) - y_origin
    print(f"[luwbc] convergence rotation {rotate_deg:.6f} deg, target domain "
          f"{si_x_range:.1f} x {si_y_range:.1f} m")

    ux, uy = lonlat_to_utm(lon.ravel(), lat.ravel(), zone=zone)
    xr, yr = rotate_xy(ux, uy, rotate_deg, pivot[0], pivot[1])
    x_src = (xr - x_origin).reshape(lon.shape)
    y_src = (yr - y_origin).reshape(lon.shape)

    # wind COMPONENTS rotate with the frame: the CSV carries rotated-local
    # u/v so the solver's axes are the rotated box; post/transform.py
    # derotates by -rotate_deg on export.  (The reference leaves the
    # sub-degree convergence rotation off its inputs but derotates on
    # export, vtk_avg_to_utm_asl_nc.py:496 — we keep both sides exact.)
    c_r, s_r = math.cos(math.radians(rotate_deg)), math.sin(math.radians(rotate_deg))
    u, v = c_r * u - s_r * v, s_r * u + c_r * v

    # deck parameters
    base_height = deck.get_float("base_height", 50.0) or 50.0
    z_limit = deck.get_float("z_limit")
    if z_limit is not None and (not math.isfinite(z_limit) or z_limit <= 0):
        z_limit = None
    mesh_base = deck.get_float("midmesh_basesize", 50.0) or 50.0

    # horizontal target grid: spacing ~ midmesh_basesize
    nx = max(1, int(round(si_x_range / mesh_base))) + 1
    ny = max(1, int(round(si_y_range / mesh_base))) + 1
    x_grid = np.linspace(0.0, si_x_range, nx)
    y_grid = np.linspace(0.0, si_y_range, ny)
    dx = x_grid[1] - x_grid[0] if nx > 1 else si_x_range
    dy = y_grid[1] - y_grid[0] if ny > 1 else si_y_range

    # vertical source levels (AGL); pressure-looking coords fall back to
    # index meters (reference :1665-1688)
    lev = np.asarray(z_levels, np.float32).reshape(-1)
    if lev.size != nz_src or not np.isfinite(lev).all():
        lev = np.arange(nz_src, dtype=np.float32)
    units = vert_units.lower()
    is_pressure = (units in ("pa", "hpa", "mb") or "mbar" in units
                   or vert_name.lower() in ("plev", "pressure", "isobaric"))
    if is_pressure and 10.0 < float(lev.min()) and float(lev.max()) < 2000.0:
        print("[luwbc] WARNING: vertical levels look like pressure; using "
              "index-based meters")
        lev = np.arange(nz_src, dtype=np.float32)
    if lev.size >= 2 and lev[1] < lev[0]:
        lev = lev[::-1].copy()
        u, v, w = u[::-1], v[::-1], w[::-1]
        if T is not None:
            T = T[::-1]
    z_src_raw = lev.copy()
    for k in range(1, z_src_raw.size):
        if z_src_raw[k] <= z_src_raw[k - 1]:
            z_src_raw[k] = z_src_raw[k - 1] + 1e-3
    z_top_agl = float(z_src_raw[-1])

    # horizontal interpolation onto the uniform meter grid
    progress.emit("Interface interpolation", indeterminate=True, force=True)
    u_m = _interp_to_grid(u, x_src, y_src, x_grid, y_grid)
    v_m = _interp_to_grid(v, x_src, y_src, x_grid, y_grid)
    w_m = _interp_to_grid(w, x_src, y_src, x_grid, y_grid)
    t_m = _interp_to_grid(T, x_src, y_src, x_grid, y_grid) if T is not None else None

    # vertical resample to ~mesh_base spacing, nearest fill outside range
    from scipy.interpolate import interp1d

    n_cell_z = max(1, int(round(z_top_agl / mesh_base)))
    z_new = np.linspace(0.0, z_top_agl, n_cell_z + 1, dtype=np.float32)
    dz = float(z_new[1] - z_new[0]) if len(z_new) > 1 else 0.0

    def vre(a):
        f = interp1d(z_src_raw, a, axis=0, bounds_error=False,
                     fill_value=(a[0], a[-1]))
        return f(z_new).astype(np.float32)

    u_m, v_m, w_m = vre(u_m), vre(v_m), vre(w_m)
    if t_m is not None:
        t_m = vre(t_m)
    nz = len(z_new)

    # DEM terrain onto the wind grid
    dem_grid = None
    dem = load_dem_lonlat(home, deck)
    if dem is not None:
        progress.emit("Terrain grid", indeterminate=True, force=True)
        pts_ll, elev = dem
        if lon_pair and lat_pair:
            inb = (float(np.nanmin(pts_ll[:, 0])), float(np.nanmax(pts_ll[:, 0])),
                   float(np.nanmin(pts_ll[:, 1])), float(np.nanmax(pts_ll[:, 1])))
            confirm_bbox_coverage("DEM", (lon_pair[0], lon_pair[1],
                                          lat_pair[0], lat_pair[1]), inb)
        dx_u, dy_u = lonlat_to_utm(pts_ll[:, 0], pts_ll[:, 1], zone=zone)
        dxr, dyr = rotate_xy(dx_u, dy_u, rotate_deg, pivot[0], pivot[1])
        dem_grid = _idw_grid(np.stack([dxr - x_origin, dyr - y_origin], axis=1),
                             np.asarray(elev, float), x_grid, y_grid)
        scale = float(os.environ.get("LUW_ELEVATION_SCALE", "1.0"))
        if scale != 1.0:
            dem_grid = dem_grid * scale

    ground_max = base_height + (float(np.nanmax(dem_grid)) if dem_grid is not None else 0.0)
    z_top_agl_out = min(z_top_agl, z_limit) if z_limit is not None else z_top_agl
    z_top_output = ground_max + z_top_agl_out

    # early writebacks (reference :1822-1826)
    deck.set_pair("si_x_cfd", (0.0, si_x_range))
    deck.set_pair("si_y_cfd", (0.0, si_y_range))
    deck.set_pair("si_z_cfd", (0.0, z_top_output))
    deck.set_text("utm_crs", f"EPSG:{epsg}", quoted=True)
    deck.set_float("rotate_deg", rotate_deg)
    deck.set_bool("origin_shift_applied", True)
    deck.set_float("center_lon", clon)
    deck.set_float("center_lat", clat)
    if deck.get_pair("cut_lon_manual") is None:
        deck.set_pair("cut_lon_manual", lon_pair)
    if deck.get_pair("cut_lat_manual") is None:
        deck.set_pair("cut_lat_manual", lat_pair)
    deck.save()

    # ---- SurfData CSV with patch faces (reference :2164-2400) -------------
    # Fully vectorized column sampling: the vertical ladder is uniform
    # (z_new = k*dz, terrain-uplifted per column), so the inverse-distance-
    # between-bracketing-levels rule reduces to array index math — the
    # reference's per-point loops take minutes at production window sizes.
    progress.emit("Writing boundary CSV", indeterminate=True, force=True)
    write_T = t_m is not None
    ground_eps = max(1e-3, min(0.1, 0.05 * dz)) if dz > 0 else 0.05
    z_top_agl2 = float(z_new[-1])

    gz_grid = base_height + (dem_grid if dem_grid is not None
                             else np.zeros((ny, nx)))

    fields3 = [u_m, v_m, w_m] + ([t_m] if write_T else [])

    def sample_many(jj, ii, z_abs, gz):
        """Vectorized column IDW sample at absolute heights (arrays (P,))."""
        zq = np.clip(z_abs - gz, 0.0, z_top_agl2)
        if nz < 2 or dz <= 0:
            return [fm_[0, jj, ii] for fm_ in fields3]
        k_lo = np.clip((zq // dz).astype(np.int64), 0, nz - 2)
        d_lo = zq - k_lo * dz
        d_up = (k_lo + 1) * dz - zq
        w_lo = 1.0 / np.maximum(d_lo, 1e-12)
        w_up = 1.0 / np.maximum(d_up, 1e-12)
        # exact-hit snapping (reference _idw_interp_1d, d < 1e-6 first-match)
        snap_lo = d_lo < 1e-6
        snap_up = (d_up < 1e-6) & ~snap_lo
        w_lo = np.where(snap_lo, 1.0, np.where(snap_up, 0.0, w_lo))
        w_up = np.where(snap_lo, 0.0, np.where(snap_up, 1.0, w_up))
        inv = 1.0 / (w_lo + w_up)
        out = []
        for fm_ in fields3:
            lo = fm_[k_lo, jj, ii]
            up = fm_[k_lo + 1, jj, ii]
            out.append((w_lo * lo + w_up * up) * inv)
        return out

    rows: list = []
    bc_sum = np.zeros(3)
    bc_n = 0

    def emit_many(xs_, ys_, zs_, vals, patch, keep_w: bool):
        nonlocal bc_n
        uu, vv = vals[0], vals[1]
        ww = vals[2] if keep_w else np.zeros_like(vals[0])
        tt = vals[3] if write_T else None
        bc_sum[0] += float(uu.sum())
        bc_sum[1] += float(vv.sum())
        bc_sum[2] += float(ww.sum())
        bc_n += len(uu)
        if write_T:
            rows.extend(
                f"{x:.3f},{y:.3f},{z:.3f},{a},{b},{c},{d},{patch}"
                for x, y, z, a, b, c, d in zip(xs_, ys_, zs_, uu, vv, ww, tt))
        else:
            rows.extend(
                f"{x:.3f},{y:.3f},{z:.3f},{a},{b},{c},{patch}"
                for x, y, z, a, b, c in zip(xs_, ys_, zs_, uu, vv, ww))

    jj_g, ii_g = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    jj_f, ii_f = jj_g.ravel(), ii_g.ravel()
    gz_f = gz_grid[jj_f, ii_f]
    open_col = gz_f < z_top_output

    # bottom: just above local terrain, w kept
    jj_b, ii_b, gz_b = jj_f[open_col], ii_f[open_col], gz_f[open_col]
    zb = gz_b + np.minimum(ground_eps, 0.5 * (z_top_output - gz_b))
    emit_many(x_grid[ii_b], y_grid[jj_b], zb,
              sample_many(jj_b, ii_b, zb, gz_b), PATCH_BOTTOM, keep_w=True)
    # top: flat cap, w = 0
    zt = np.full(len(jj_b), z_top_output)
    emit_many(x_grid[ii_b], y_grid[jj_b], zt,
              sample_many(jj_b, ii_b, zt, gz_b), PATCH_TOP, keep_w=False)

    # sides: ground point + k*dz AGL levels (w = 0)
    def side_face(jj_s, ii_s, patch):
        gz_s = gz_grid[jj_s, ii_s]
        keep = gz_s < z_top_output
        jj_s, ii_s, gz_s = jj_s[keep], ii_s[keep], gz_s[keep]
        if not len(jj_s):
            return
        emit_many(x_grid[ii_s], y_grid[jj_s], gz_s,
                  sample_many(jj_s, ii_s, gz_s, gz_s), patch, keep_w=False)
        if dz <= 0:
            return
        k_max = np.minimum(((z_top_output - gz_s) / dz + 1e-6).astype(np.int64),
                           nz - 1)
        for k in range(1, nz):
            on = k <= k_max
            z_out = gz_s + k * dz
            on &= z_out < z_top_output - 1e-6
            if not on.any():
                continue
            emit_many(x_grid[ii_s[on]], y_grid[jj_s[on]], z_out[on],
                      sample_many(jj_s[on], ii_s[on], z_out[on], gz_s[on]),
                      patch, keep_w=False)

    ii_all = np.arange(nx)
    jj_all = np.arange(ny)
    side_face(np.zeros(nx, np.int64), ii_all, PATCH_SOUTH)
    side_face(np.full(nx, ny - 1, np.int64), ii_all, PATCH_NORTH)
    side_face(jj_all, np.zeros(ny, np.int64), PATCH_WEST)
    side_face(jj_all, np.full(ny, nx - 1, np.int64), PATCH_EAST)

    out = home / "proj_temp" / f"SurfData_{dt}.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    header = "X,Y,Z,u,v,w,T,patch" if write_T else "X,Y,Z,u,v,w,patch"
    body = header + "\n" + "\n".join(rows) + "\n"
    # the reference writes SurfData_Latest.csv first and copies it to the
    # timestamped name (:2164, :2400-2410) — keep both artifacts
    (home / "proj_temp" / "SurfData_Latest.csv").write_text(body)
    out.write_text(body)

    # ---- late writebacks (reference :2413-2438) ----------------------------
    um_vol = [float(np.nanmean(u_m)), float(np.nanmean(v_m)),
              float(np.nanmean(w_m))]
    um_bc = (bc_sum / max(bc_n, 1)).tolist()
    mean_u, mean_v = um_vol[0], um_vol[1]
    if abs(mean_u) >= abs(mean_v):
        face = "+x" if mean_u >= 0 else "-x"
        parallel, perp = abs(mean_u), mean_v
    else:
        face = "+y" if mean_v >= 0 else "-y"
        parallel, perp = abs(mean_v), mean_u
    theta = math.degrees(math.atan2(abs(perp), parallel)) if parallel else 90.0
    yaw = (1.0 if perp >= 0 else -1.0) * theta

    deck.set_list("um_vol", um_vol)
    deck.set_list("um_bc", um_bc)
    deck.set_text("downstream_bc", face, quoted=True)
    deck.set_float("downstream_bc_yaw", yaw, precision=2)
    deck.save()
    progress.done("Writing boundary CSV", f"{len(rows)} samples")
    print(f"[luwbc] wrote {out.name} ({len(rows)} samples, patch column, "
          f"{'T, ' if write_T else ''}grid {nx}x{ny}x{nz}), EPSG:{epsg}, "
          f"rotate {rotate_deg:.4f} deg, downstream {face} yaw {yaw:.2f}")
    return out


# ---------------------------------------------------------------------------
# dependency-light scattered path (pre-extracted samples)
# ---------------------------------------------------------------------------


def build_from_samples(deck_path: Path, lon, lat, z_agl, u, v, w, T=None) -> Path:
    """Scattered samples -> SurfData CSV (no patch column — the solver's
    high-order/nearest BC paths consume it).  Same projection/rotation
    semantics as the structured path."""
    deck = load_deck(deck_path)
    home = deck_path.parent
    dt = deck.get_text("datetime") or "20990101120000"

    lon = np.asarray(lon, float)
    lat = np.asarray(lat, float)
    lon_pair = deck.get_pair("cut_lon_manual")
    lat_pair = deck.get_pair("cut_lat_manual")
    if lon_pair and lat_pair:
        confirm_bbox_coverage(
            "Wind samples",
            (lon_pair[0], lon_pair[1], lat_pair[0], lat_pair[1]),
            (float(lon.min()), float(lon.max()),
             float(lat.min()), float(lat.max())))
        inside = ((lon >= lon_pair[0]) & (lon <= lon_pair[1])
                  & (lat >= lat_pair[0]) & (lat <= lat_pair[1]))
        if inside.sum() < 8:
            print(f"[luwbc] WARNING: only {int(inside.sum())} samples inside "
                  "the lon/lat window; using all samples")
            inside = np.ones(len(lon), bool)
    else:
        inside = np.ones(len(lon), bool)
        lon_pair = (float(lon.min()), float(lon.max()))
        lat_pair = (float(lat.min()), float(lat.max()))
    lon, lat = lon[inside], lat[inside]
    z_agl = np.asarray(z_agl, float)[inside]
    u = np.asarray(u, float)[inside]
    v = np.asarray(v, float)[inside]
    w = np.asarray(w, float)[inside]
    T_arr = np.asarray(T, float)[inside] if T is not None else None

    clon = 0.5 * (lon_pair[0] + lon_pair[1])
    zone = utm_zone_for(clon)
    epsg = utm_epsg_for(clon, 0.5 * (lat_pair[0] + lat_pair[1]))
    rot, pivot, corners = bbox_rotation(lon_pair, lat_pair, zone)
    ux, uy = lonlat_to_utm(lon, lat, zone=zone)
    xr, yr = rotate_xy(ux, uy, rot, pivot[0], pivot[1])
    xr_c, yr_c = rotate_xy(corners[:, 0], corners[:, 1], rot, pivot[0], pivot[1])
    x0, y0 = float(xr_c.min()), float(yr_c.min())
    X = xr - x0
    Y = yr - y0
    # wind components rotate with the frame (see build_structured)
    c_r, s_r = math.cos(math.radians(rot)), math.sin(math.radians(rot))
    u, v = c_r * u - s_r * v, s_r * u + c_r * v

    mean_u, mean_v = float(u.mean()), float(v.mean())
    if abs(mean_u) >= abs(mean_v):
        face = "+x" if mean_u >= 0 else "-x"
        parallel, perp = abs(mean_u), mean_v
    else:
        face = "+y" if mean_v >= 0 else "-y"
        parallel, perp = abs(mean_v), mean_u
    theta = math.degrees(math.atan2(abs(perp), parallel)) if parallel else 90.0
    yaw = (1.0 if perp >= 0 else -1.0) * theta

    base_h = deck.get_float("base_height", 50.0) or 50.0
    Z = z_agl + base_h

    out = home / "proj_temp" / f"SurfData_{dt}.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    cols = [X, Y, Z, u, v, w]
    header = "X,Y,Z,u,v,w"
    if T_arr is not None:
        cols.append(T_arr)
        header += ",T"
    np.savetxt(out, np.stack(cols, axis=1), delimiter=",", header=header,
               comments="", fmt="%.6f")

    deck.set_pair("si_x_cfd", (0.0, float(xr_c.max()) - x0))
    deck.set_pair("si_y_cfd", (0.0, float(yr_c.max()) - y0))
    deck.set_pair("si_z_cfd", (0.0, float(Z.max())))
    deck.set_text("utm_crs", f"EPSG:{epsg}", quoted=True)
    deck.set_float("rotate_deg", rot)
    deck.set_list("um_vol", [mean_u, mean_v, float(w.mean())])
    deck.set_list("um_bc", [mean_u, mean_v, float(w.mean())])
    deck.set_text("downstream_bc", face, quoted=True)
    deck.set_float("downstream_bc_yaw", yaw, precision=2)
    deck.set_bool("origin_shift_applied", True)
    deck.set_float("center_lon", clon)
    deck.set_float("center_lat", 0.5 * (lat_pair[0] + lat_pair[1]))
    if deck.get_pair("cut_lon_manual") is None:
        deck.set_pair("cut_lon_manual", lon_pair)
    if deck.get_pair("cut_lat_manual") is None:
        deck.set_pair("cut_lat_manual", lat_pair)
    deck.save()
    print(f"[luwbc] wrote {out.name} ({len(X)} samples), EPSG:{epsg}, "
          f"rotate {rot:.4f} deg, downstream {face}")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # reference CLI flags (1_buildBC.py argparse): --elevation-scale scales
    # DEM relief for visualization/testing; --write-vtk is accepted for
    # compatibility (the boundary VTK debug dump is not reproduced)
    elevation_scale = 1.0
    pos = []
    it = iter(argv)
    for a in it:
        if a == "--elevation-scale":
            val = next(it, None)
            if val is None:
                print("luwbc: --elevation-scale requires a value")
                return 2
            elevation_scale = float(val)
        elif a.startswith("--elevation-scale="):
            elevation_scale = float(a.split("=", 1)[1])
        elif a == "--write-vtk":
            pass
        else:
            pos.append(a)
    if len(pos) != 1:
        print("Usage: luwbc <deck file> [--elevation-scale S] [--write-vtk]")
        return 2
    if elevation_scale != 1.0:
        import os

        os.environ["LUW_ELEVATION_SCALE"] = str(elevation_scale)
        print(f"[luwbc] elevation scale {elevation_scale}x")
    deck_path = Path(pos[0]).expanduser().resolve()
    home = deck_path.parent

    # dependency-light path: pre-extracted samples table
    light = home / "proj_temp" / "wind_samples.csv"
    if light.exists():
        raw = np.loadtxt(light, delimiter=",", skiprows=1, ndmin=2)
        T = raw[:, 6] if raw.shape[1] >= 7 else None
        build_from_samples(deck_path, raw[:, 0], raw[:, 1], raw[:, 2],
                           raw[:, 3], raw[:, 4], raw[:, 5], T)
        return 0

    # WRF/NetCDF path: xarray when installed, scipy NetCDF-3 fallback
    from .wrf_ingest import build_from_wrf

    try:
        return build_from_wrf(deck_path)
    except FileNotFoundError as e:
        print(f"[luwbc] ERROR: {e}\n"
              "  Provide wind_bc/<case>_<datetime>.nc (NetCDF-3 classic works "
              "without the GIS stack; NetCDF-4 needs xarray), or pre-extract "
              "samples to proj_temp/wind_samples.csv (lon,lat,z_agl,u,v,w[,T]).")
        return 1
    except Exception as e:   # noqa: BLE001 — scipy raises bare errors on NC4
        if "is not a valid NetCDF 3 file" in str(e):
            print("[luwbc] ERROR: the NetCDF file is NetCDF-4/HDF5 and xarray "
                  "is not installed.  Convert with `nccopy -k classic` or "
                  "install xarray/netCDF4.")
            return 1
        raise


if __name__ == "__main__":
    sys.exit(main())
