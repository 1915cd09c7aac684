"""luwvox — geometry stage: terrain + building prisms -> watertight case STL.

Clean-room equivalent of bridge_core/3_voxelization.py: interpolates the DEM
point cloud onto a regular terrain grid (IDW / kriging / kriging_gpu via
pre/terrain.py — the device kriging replaces the reference's numba.cuda
kernel),
emits proj_temp/interpolated_dem.csv, builds a watertight terrain surface
mesh plus per-building prisms seated on the terrain, and writes
proj_temp/<case>_DG.stl.  Mesh construction is vectorized numpy (no trimesh
dependency).

Building footprints come from the cropped shapefile when geopandas is
available, else from proj_temp/buildings.csv (columns: id,x,y[,height] —
polygon vertices grouped by id), else terrain-only.

A copy of `latticeurbanwind_tpu/pre/voxelization.py` with one option more:
`--device` (default cuda) names where `kriging_gpu` solves its systems;
nothing else in the stage runs on a device.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..cli import pop_device
from ..deck import load_deck
from ..geometry import Mesh, write_stl
from ..io.progress import ProgressEmitter
from .terrain import TerrainConfig, interpolate_terrain_grid, terrain_config_from_deck


def terrain_surface_mesh(x: np.ndarray, y: np.ndarray, z: np.ndarray,
                         base_z: float) -> np.ndarray:
    """Watertight slab: top follows z(y, x), flat bottom at base_z, side walls.

    Returns (T, 3, 3) triangles.  Vectorized quad triangulation.
    """
    ny, nx = z.shape
    gx, gy = np.meshgrid(x, y)
    top = np.stack([gx, gy, z], axis=2)              # (ny, nx, 3)
    bot = np.stack([gx, gy, np.full_like(z, base_z)], axis=2)

    def quads_to_tris(p00, p10, p01, p11, flip=False):
        t1 = np.stack([p00, p10, p11], axis=1)
        t2 = np.stack([p00, p11, p01], axis=1)
        tris = np.concatenate([t1, t2], axis=0)
        if flip:
            tris = tris[:, ::-1, :]
        return tris

    tris = []
    # top surface (up-facing) and bottom (down-facing)
    p00 = top[:-1, :-1].reshape(-1, 3)
    p10 = top[:-1, 1:].reshape(-1, 3)
    p01 = top[1:, :-1].reshape(-1, 3)
    p11 = top[1:, 1:].reshape(-1, 3)
    tris.append(quads_to_tris(p00, p10, p01, p11))
    q00 = bot[:-1, :-1].reshape(-1, 3)
    q10 = bot[:-1, 1:].reshape(-1, 3)
    q01 = bot[1:, :-1].reshape(-1, 3)
    q11 = bot[1:, 1:].reshape(-1, 3)
    tris.append(quads_to_tris(q00, q10, q01, q11, flip=True))

    # four side walls stitching top rim to bottom rim
    def wall(t_edge, b_edge, flip):
        p0 = t_edge[:-1]
        p1 = t_edge[1:]
        q0 = b_edge[:-1]
        q1 = b_edge[1:]
        return quads_to_tris(q0, q1, p0, p1, flip=flip)

    tris.append(wall(top[0], bot[0], flip=False))        # south wall
    tris.append(wall(top[-1], bot[-1], flip=True))       # north wall
    tris.append(wall(top[:, 0], bot[:, 0], flip=True))   # west wall
    tris.append(wall(top[:, -1], bot[:, -1], flip=False))  # east wall
    return np.concatenate(tris, axis=0).astype(np.float32)


def extrude_polygon_prism(poly_xy: np.ndarray, z0: float, z1: float) -> np.ndarray:
    """Prism from a simple polygon footprint: fan-triangulated caps + walls."""
    poly = np.asarray(poly_xy, dtype=np.float64)
    if len(poly) >= 2 and np.allclose(poly[0], poly[-1]):
        poly = poly[:-1]
    n = len(poly)
    if n < 3:
        return np.zeros((0, 3, 3), np.float32)
    # ensure counter-clockwise orientation (positive shoelace area)
    area2 = np.sum(poly[:, 0] * np.roll(poly[:, 1], -1)
                   - np.roll(poly[:, 0], -1) * poly[:, 1])
    if area2 < 0:
        poly = poly[::-1]
    tris = []
    # caps (fan; exact for convex, acceptable for near-convex building rings)
    for i in range(1, n - 1):
        a, b, c = poly[0], poly[i], poly[i + 1]
        tris.append([[*a, z1], [*b, z1], [*c, z1]])          # top, up-facing
        tris.append([[*a, z0], [*c, z0], [*b, z0]])          # bottom, down
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        tris.append([[*a, z0], [*b, z0], [*b, z1]])
        tris.append([[*a, z0], [*b, z1], [*a, z1]])
    return np.asarray(tris, dtype=np.float32)


def load_building_footprints(home: Path, deck) -> List[Tuple[np.ndarray, float]]:
    """[(polygon_xy, height_m)] from the cropped shapefile or buildings.csv."""
    height_field = (deck.get_text("terr_voxel_height_field") or "auto").strip()
    ignore_under = deck.get_float("terr_voxel_ignore_under", 0.0) or 0.0
    out: List[Tuple[np.ndarray, float]] = []

    shp_candidates = sorted((home / "proj_temp").glob("*.shp"))
    if shp_candidates:
        try:
            import geopandas as gpd

            gdf = gpd.read_file(shp_candidates[0])
            cols = [c for c in gdf.columns if c != "geometry"]
            hcol = None
            if height_field.lower() not in ("auto", "inferred", ""):
                hcol = height_field if height_field in cols else None
            if hcol is None:
                for cand in ("height", "HEIGHT", "Height", "height_m", "HEIGHT_M", "h"):
                    if cand in cols:
                        hcol = cand
                        break
            for _, row in gdf.iterrows():
                h = float(row[hcol]) if hcol else 10.0
                if h <= ignore_under:
                    continue
                geom = row.geometry
                polys = getattr(geom, "geoms", [geom])
                for p in polys:
                    out.append((np.asarray(p.exterior.coords), h))
            return out
        except ImportError:
            print("[luwvox] geopandas unavailable; trying buildings.csv fallback")

    csv_path = home / "proj_temp" / "buildings.csv"
    if csv_path.exists():
        rows = {}
        heights = {}
        for line in csv_path.read_text().splitlines()[1:]:
            parts = line.split(",")
            if len(parts) < 3:
                continue
            bid = parts[0].strip()
            rows.setdefault(bid, []).append((float(parts[1]), float(parts[2])))
            if len(parts) >= 4 and parts[3].strip():
                heights[bid] = float(parts[3])
        for bid, pts in rows.items():
            h = heights.get(bid, 10.0)
            if h > ignore_under and len(pts) >= 3:
                out.append((np.asarray(pts), h))
    return out


def main(argv=None) -> int:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    if len(argv) != 1:
        print("Usage: luwvox <deck file> [--device cuda|cpu]")
        return 2
    deck_path = Path(argv[0]).expanduser().resolve()
    deck = load_deck(deck_path)
    home = deck_path.parent
    progress = ProgressEmitter("voxelize")
    casename = deck.get_text("casename") or "case"
    geometry_mode = int(deck.get_text("geometry_mode", "2") or 2)

    x_pair = deck.get_pair("si_x_cfd")
    y_pair = deck.get_pair("si_y_cfd")
    if x_pair is None or y_pair is None:
        print("ERROR: deck missing si_x_cfd/si_y_cfd (run luwbc first)")
        return 1
    base_h = deck.get_float("base_height", 50.0) or 50.0
    tcfg = terrain_config_from_deck(deck)

    # DEM points: proj_temp/dem_points.csv (x,y,elevation) written by earlier
    # stages, else flat terrain at z = base_height
    dem_path = home / "proj_temp" / "dem_points.csv"

    def axis(lo, hi, res):
        # exact endpoints: the STL bounding box must match the SurfData
        # extents within luwval's 0.1% tolerance
        n = max(2, int(round((hi - lo) / res)) + 1)
        return np.linspace(lo, hi, n)

    xs = axis(x_pair[0], x_pair[1], tcfg.grid_resolution)
    ys = axis(y_pair[0], y_pair[1], tcfg.grid_resolution)
    use_terrain = geometry_mode in (1, 2)
    if dem_path.exists() and use_terrain:
        raw = np.loadtxt(dem_path, delimiter=",", skiprows=1, ndmin=2)
        dem_xy, dem_z = raw[:, :2], raw[:, 2]
        progress.emit("Interpolating terrain", force=True)
        zgrid = base_h + interpolate_terrain_grid(dem_xy, dem_z, xs, ys, tcfg,
                                                 device=device)
        print(f"[luwvox] terrain: {tcfg.approach} on {len(dem_z)} DEM points -> "
              f"{zgrid.shape[1]}x{zgrid.shape[0]} grid, "
              f"z range {zgrid.min():.2f}..{zgrid.max():.2f} m")
    else:
        zgrid = np.full((len(ys), len(xs)), base_h)
        if use_terrain:
            print("[luwvox] no DEM points found; flat terrain at base_height")

    # interpolated_dem.csv contract (consumed by the solver's profile mode,
    # reference: setup.cpp:2153, 4095-4113)
    gx, gy = np.meshgrid(xs, ys)
    dem_csv = home / "proj_temp" / "interpolated_dem.csv"
    dem_csv.parent.mkdir(parents=True, exist_ok=True)
    arr = np.stack([gx.ravel(), gy.ravel(), (zgrid - base_h).ravel()], axis=1)
    header = "x,y,elevation"
    np.savetxt(dem_csv, arr, delimiter=",", header=header, comments="", fmt="%.4f")
    print(f"[luwvox] wrote {dem_csv.name} ({len(arr)} points)")

    tris = [terrain_surface_mesh(xs, ys, zgrid, base_z=0.0)]

    buildings = load_building_footprints(home, deck) if geometry_mode in (0, 2) else []
    if buildings:
        progress.emit("Extruding buildings", force=True)
        # per-building base elevation: terrain height at footprint centroid
        for poly, h in buildings:
            cx, cy = poly[:, 0].mean(), poly[:, 1].mean()
            ix = int(np.clip(np.searchsorted(xs, cx), 0, len(xs) - 1))
            iy = int(np.clip(np.searchsorted(ys, cy), 0, len(ys) - 1))
            zb = float(zgrid[iy, ix])
            tris.append(extrude_polygon_prism(poly, 0.0, zb + h))
        print(f"[luwvox] extruded {len(buildings)} buildings")
    elif geometry_mode in (0, 2):
        print("[luwvox] no building footprints found; terrain-only STL")

    mesh = Mesh(tris=np.concatenate([t for t in tris if len(t)], axis=0))
    stl_path = home / "proj_temp" / f"{casename}_DG.stl"
    write_stl(stl_path, mesh)
    print(f"[luwvox] wrote {stl_path.name}: {len(mesh.tris)} triangles, "
          f"bounds {mesh.pmin.round(1)}..{mesh.pmax.round(1)}")
    progress.done("Voxelization")
    return 0


if __name__ == "__main__":
    sys.exit(main())
