"""luwcut — building footprint shapefile crop/clean stage.

Clean-room equivalent of bridge_core/2_shpCutter.py: crop the building
shapefile to the deck's lon/lat bbox, fix invalid geometries, drop
small rings, merge overlapping buildings with height merge, auto-detect the
height column, write the cropped shapefile (+ preview PNG) into proj_temp.

Uses geopandas/shapely when installed; otherwise the pure-python path below
reads the shapefile itself.  The footprint data also lands in
proj_temp/buildings.csv (id,x,y,height) — the dependency-light contract
consumed by luwvox.

A copy of `latticeurbanwind_tpu/pre/shpcutter.py` but for two things that
needed matplotlib there: the overlap merge's vertex-in-polygon test is
`points_in_ring` below (the even-odd crossing rule in numpy), and the
`<casename>_buildings.png` preview is rasterised into an image array and
written by `io/png.py` (outlines only; the title goes into its `tEXt`
chunk).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..deck import load_deck
from ..cli.inspect_tools import resolve_shp_path


PREVIEW_PX = 770                # the JAX preview's 7 in at 110 dpi
PREVIEW_MARGIN_PX = 20


def points_in_ring(ring: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Which of the points (P, 2) lie inside the closed ring (E, 2), by the
    even-odd rule: a point is inside when a ray from it towards +x crosses
    the ring's edges an odd number of times.  An edge counts when its two
    ends lie on either side of the point's y (an end at the same y counts
    as above) and the crossing lies right of the point, the comparison
    written as matplotlib's `Path.contains_points` writes it, so the two
    agree away from the edges; a point on an edge may fall either way."""
    ring = np.asarray(ring, np.float64)
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    x0, y0 = ring[:, 0][None, :], ring[:, 1][None, :]
    x1, y1 = np.roll(ring[:, 0], -1)[None, :], np.roll(ring[:, 1], -1)[None, :]
    tx, ty = pts[:, 0][:, None], pts[:, 1][:, None]
    above0 = y0 >= ty
    above1 = y1 >= ty
    right = ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == above1
    return ((above0 != above1) & right).sum(axis=1) % 2 == 1


def write_preview(path: Path, rings, title: str) -> Path:
    """The footprints' outlines, blue on white, at equal scale on both axes
    (north up), into a PREVIEW_PX square PNG with `title` in its text
    chunk."""
    from ..io.png import write_png
    from ..run.render import draw_segments

    img = np.ones((PREVIEW_PX, PREVIEW_PX, 3), np.float32)
    pts = np.concatenate([np.asarray(r, np.float64) for r in rings])
    lo = pts.min(axis=0)
    span = max(float((pts.max(axis=0) - lo).max()), 1e-12)
    scale = (PREVIEW_PX - 1 - 2 * PREVIEW_MARGIN_PX) / span
    a, b = [], []
    for ring in rings:
        px = (np.asarray(ring, np.float64) - lo) * scale + PREVIEW_MARGIN_PX
        px[:, 1] = PREVIEW_PX - 1 - px[:, 1]
        a.append(px)
        b.append(np.roll(px, -1, axis=0))
    a, b = np.concatenate(a), np.concatenate(b)
    rgb = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (len(a), 1))
    return write_png(path, draw_segments(img, a, b, rgb), title)


def _height_column(gdf, explicit: str):
    cols = [c for c in gdf.columns if c != "geometry"]
    if explicit and explicit.lower() not in ("auto", "inferred", ""):
        if explicit in cols:
            return explicit
        print(f"[luwcut] WARNING: height field {explicit!r} not found; auto-detecting")
    for cand in ("height", "HEIGHT", "Height", "height_m", "HEIGHT_M", "h",
                 "bldg_h", "BLDG_H", "floor", "FLOOR"):
        if cand in cols:
            return cand
    return None


def _main_pure(deck, home: Path) -> int:
    """GIS-less path: pure-python shapefile reader (pre/shp_reader.py).

    Reads the polygon .shp/.dbf directly, auto-detects the height column,
    crops to the deck's cut lon/lat bbox, drops degenerate rings, converts
    lon/lat footprints to the case's local rotated frame via TransformModel
    (post/transform.py — requires luwbc to have run first), and writes the
    buildings.csv contract luwvox consumes.
    """
    if (home / "proj_temp" / "buildings.csv").exists():
        print("[luwcut] geopandas unavailable; using existing "
              "proj_temp/buildings.csv")
        return 0
    from .shp_reader import polygon_defects, read_shp

    try:
        shp = resolve_shp_path(home, deck)
    except FileNotFoundError as e:
        print(f"[luwcut] ERROR: {e} (and no proj_temp/buildings.csv fallback)")
        return 1
    f = read_shp(shp)
    print(f"[luwcut] pure-python reader: {shp.name} ({f.shape_name}, "
          f"{len(f.records)} records)")

    # height column auto-detection on the dbf attributes
    explicit = (deck.get_text("terr_voxel_height_field") or "auto").strip()
    hcol = None
    if f.fields:
        cands = ([explicit] if explicit.lower() not in ("auto", "inferred", "")
                 else []) + ["height", "HEIGHT", "Height", "height_m",
                             "HEIGHT_M", "h", "bldg_h", "BLDG_H"]
        hcol = next((c for c in cands if c in f.fields), None)
    ignore_under = deck.get_float("terr_voxel_ignore_under", 0.0) or 0.0

    lon_pair = deck.get_pair("cut_lon_manual")
    lat_pair = deck.get_pair("cut_lat_manual")
    geographic = abs(f.bbox[0]) <= 360 and abs(f.bbox[3]) <= 360
    tm = None
    if geographic:
        try:
            from ..post.transform import TransformModel

            sx = deck.get_pair("si_x_cfd") or (0.0, 0.0)
            sy = deck.get_pair("si_y_cfd") or (0.0, 0.0)
            tm = TransformModel.from_deck(deck, (sx[1], sy[1]))
        except (ValueError, TypeError):
            print("[luwcut] ERROR: lon/lat shapefile needs the deck's "
                  "cut_lon/lat + generated fields (run luwbc first)")
            return 1

    kept_rings = []           # (ring lon/lat, height)
    dropped = 0
    for rec in f.records:
        if polygon_defects(rec):
            dropped += 1
            continue
        h = 10.0
        if hcol is not None and rec.number - 1 < len(f.attributes):
            try:
                h = float(f.attributes[rec.number - 1].get(hcol) or 10.0)
            except (TypeError, ValueError):
                h = 10.0
        if h <= ignore_under:
            dropped += 1
            continue
        ring = np.asarray(rec.parts[0])           # exterior ring
        if lon_pair and lat_pair and geographic:
            inside = ((ring[:, 0] >= lon_pair[0]) & (ring[:, 0] <= lon_pair[1])
                      & (ring[:, 1] >= lat_pair[0]) & (ring[:, 1] <= lat_pair[1]))
            if not inside.any():
                dropped += 1
                continue
        kept_rings.append((ring, h))
    kept = len(kept_rings)

    # overlapping-building merge with height merge (reference 2_shpCutter
    # :463): cluster footprints that GEOMETRICALLY overlap (vertex-in-
    # polygon test, not mere bbox contact — bbox chains must not inherit a
    # distant tower's height) and raise each member to the cluster's max —
    # voxel-equivalent to stamping the geometric union at that height.
    # Candidate pairs come from a bbox grid hash, so city-scale inputs stay
    # near-linear instead of O(n^2).
    n = len(kept_rings)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    boxes = np.array([(r[:, 0].min(), r[:, 0].max(), r[:, 1].min(), r[:, 1].max())
                      for r, _ in kept_rings]) if n else np.zeros((0, 4))
    if n:
        cell = max(float(np.median(boxes[:, 1] - boxes[:, 0])), 1e-9)
        grid: dict = {}
        for i in range(n):
            for gx in range(int(boxes[i, 0] / cell), int(boxes[i, 1] / cell) + 1):
                for gy in range(int(boxes[i, 2] / cell), int(boxes[i, 3] / cell) + 1):
                    grid.setdefault((gx, gy), []).append(i)

        def _edges_cross(ra, rb):
            """Any segment of ring A properly intersecting a segment of B
            (covers crossing footprints with no vertex inside the other)."""
            a0 = ra
            a1 = np.roll(ra, -1, axis=0)
            b0 = rb
            b1 = np.roll(rb, -1, axis=0)
            d1 = a1 - a0                                     # (Ea, 2)
            d2 = b1 - b0                                     # (Eb, 2)
            # orientation cross products, broadcast (Ea, Eb)
            w = b0[None, :, :] - a0[:, None, :]
            c1 = d1[:, None, 0] * w[:, :, 1] - d1[:, None, 1] * w[:, :, 0]
            w2 = (b1[None, :, :] - a0[:, None, :])
            c2 = d1[:, None, 0] * w2[:, :, 1] - d1[:, None, 1] * w2[:, :, 0]
            v = a0[:, None, :] - b0[None, :, :]
            c3 = d2[None, :, 0] * v[:, :, 1] - d2[None, :, 1] * v[:, :, 0]
            v2 = (a1[:, None, :] - b0[None, :, :])
            c4 = d2[None, :, 0] * v2[:, :, 1] - d2[None, :, 1] * v2[:, :, 0]
            return bool(((c1 * c2 < 0) & (c3 * c4 < 0)).any())

        def overlaps(i, j):
            a, b = boxes[i], boxes[j]
            if a[0] > b[1] or b[0] > a[1] or a[2] > b[3] or b[2] > a[3]:
                return False
            if (points_in_ring(kept_rings[i][0], kept_rings[j][0]).any()
                    or points_in_ring(kept_rings[j][0], kept_rings[i][0]).any()):
                return True
            # crossing shapes (plus-sign overlap) have no contained vertex
            return _edges_cross(kept_rings[i][0], kept_rings[j][0])

        seen_pairs = set()
        for bucket in grid.values():
            for ai in range(len(bucket)):
                for bi in range(ai + 1, len(bucket)):
                    i, j = bucket[ai], bucket[bi]
                    if (i, j) in seen_pairs:
                        continue
                    seen_pairs.add((i, j))
                    if overlaps(i, j):
                        ri, rj = find(i), find(j)
                        if ri != rj:
                            parent[rj] = ri
    cluster_h = {}
    for i in range(n):
        r = find(i)
        cluster_h[r] = max(cluster_h.get(r, 0.0), kept_rings[i][1])
    merged = sum(1 for i in range(n) if find(i) != i)
    heights = [cluster_h[find(i)] for i in range(n)]

    out = home / "proj_temp" / "buildings.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = ["id,x,y,height"]
    for i, (ring, _) in enumerate(kept_rings):
        if tm is not None:
            x, y = tm.lonlat_to_local(ring[:, 0], ring[:, 1])
        else:
            x, y = ring[:, 0], ring[:, 1]
        for xi, yi in zip(x, y):
            rows.append(f"{i},{xi:.4f},{yi:.4f},{heights[i]:.2f}")
    out.write_text("\n".join(rows) + "\n")

    # the cropped-shapefile artifact (reference output contract) + preview
    casename = deck.get_text("casename") or "case"
    if kept:
        from .shp_reader import write_polygon_shp

        shp_out = home / "proj_temp" / f"{casename}_buildings.shp"
        write_polygon_shp(shp_out, [r for r, _ in kept_rings], heights=heights)
        write_preview(home / "proj_temp" / f"{casename}_buildings.png",
                      [r for r, _ in kept_rings],
                      f"{casename}: {kept} footprints")
        print(f"[luwcut] wrote {shp_out.name} + preview PNG")
    print(f"[luwcut] wrote buildings.csv: {kept} footprints, "
          f"{merged} merged into overlap clusters "
          f"({dropped} dropped: degenerate/outside/under-height)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: luwcut <deck file>")
        return 2
    deck_path = Path(argv[0]).expanduser().resolve()
    deck = load_deck(deck_path)
    home = deck_path.parent

    try:
        import geopandas as gpd
        from shapely.geometry import box
        from shapely.validation import make_valid
    except ImportError:
        return _main_pure(deck, home)

    try:
        shp = resolve_shp_path(home, deck)
    except FileNotFoundError as e:
        print(f"[luwcut] ERROR: {e}")
        return 1
    gdf = gpd.read_file(shp)
    lon = deck.get_pair("cut_lon_manual")
    lat = deck.get_pair("cut_lat_manual")
    if lon and lat:
        bbox = box(lon[0], lat[0], lon[1], lat[1])
        gdf = gdf[gdf.intersects(bbox)].copy()
        gdf["geometry"] = gdf.geometry.intersection(bbox)
    gdf["geometry"] = gdf.geometry.apply(
        lambda g: make_valid(g) if not g.is_valid else g)
    gdf = gdf[~gdf.geometry.is_empty]

    hcol = _height_column(gdf, deck.get_text("terr_voxel_height_field") or "auto")
    ignore_under = deck.get_float("terr_voxel_ignore_under", 0.0) or 0.0
    if hcol:
        gdf = gdf[gdf[hcol].astype(float) > ignore_under]

    # merge overlapping buildings, keeping the max height of the merged set
    merged = gdf.geometry.union_all() if hasattr(gdf.geometry, "union_all") \
        else gdf.geometry.unary_union
    polys = list(getattr(merged, "geoms", [merged]))
    heights = []
    for p in polys:
        if hcol:
            hits = gdf[gdf.intersects(p)]
            heights.append(float(hits[hcol].astype(float).max()) if len(hits) else 10.0)
        else:
            heights.append(10.0)

    out_shp = home / "proj_temp" / f"{deck.get_text('casename') or 'case'}_buildings.shp"
    out = gpd.GeoDataFrame({"height": heights, "geometry": polys}, crs=gdf.crs)
    out.to_file(out_shp)
    # dependency-light contract for luwvox
    rows = ["id,x,y,height"]
    for i, (p, h) in enumerate(zip(polys, heights)):
        for x, y in np.asarray(p.exterior.coords):
            rows.append(f"{i},{x:.4f},{y:.4f},{h:.2f}")
    (home / "proj_temp" / "buildings.csv").write_text("\n".join(rows) + "\n")
    print(f"[luwcut] wrote {out_shp.name}: {len(polys)} merged footprints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
