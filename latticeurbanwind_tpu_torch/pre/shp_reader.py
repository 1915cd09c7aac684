"""Minimal pure-Python ESRI shapefile (.shp/.dbf) reader.

The reference's shapefile tools (tools_core/shpTester.py, shpInspect.py,
bridge_core shp_cutter.py) sit on geopandas/fiona, which are not part of
this image.  Polygon-class shapefiles are a simple well-documented binary
format, so the geometry path is implemented directly here; tools upgrade to
geopandas/shapely when importable (cli/dem_shp_tools.py) and fall back to
this reader otherwise.

Supports shape types: 1/11/21 (Point*), 3/13/23 (PolyLine*), 5/15/25
(Polygon*) — Z/M variants are read as 2-D.  The companion .dbf (dBase III)
attribute table is parsed for field names and text/numeric values.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SHAPE_NAMES = {
    0: "Null", 1: "Point", 3: "PolyLine", 5: "Polygon", 8: "MultiPoint",
    11: "PointZ", 13: "PolyLineZ", 15: "PolygonZ", 18: "MultiPointZ",
    21: "PointM", 23: "PolyLineM", 25: "PolygonM", 28: "MultiPointM",
}
_POLYGONS = (5, 15, 25)
_POLYLINES = (3, 13, 23)
_POINTS = (1, 11, 21)


@dataclass
class ShpRecord:
    number: int
    shape_type: int
    # polygons/polylines: list of rings/parts, each a list of (x, y)
    parts: List[List[Tuple[float, float]]] = field(default_factory=list)
    point: Optional[Tuple[float, float]] = None


@dataclass
class ShpFile:
    shape_type: int
    bbox: Tuple[float, float, float, float]   # xmin, ymin, xmax, ymax
    records: List[ShpRecord]
    fields: List[str] = field(default_factory=list)
    attributes: List[Dict[str, object]] = field(default_factory=list)

    @property
    def shape_name(self) -> str:
        return SHAPE_NAMES.get(self.shape_type, f"type{self.shape_type}")


def _read_multipart(buf: bytes) -> List[List[Tuple[float, float]]]:
    # after shape-type int: box(4d), numParts(i), numPoints(i), parts, points
    num_parts, num_points = struct.unpack_from("<ii", buf, 36)
    part_idx = list(struct.unpack_from(f"<{num_parts}i", buf, 44))
    pts_off = 44 + 4 * num_parts
    flat = struct.unpack_from(f"<{2 * num_points}d", buf, pts_off)
    pts = [(flat[2 * i], flat[2 * i + 1]) for i in range(num_points)]
    part_idx.append(num_points)
    return [pts[part_idx[k]:part_idx[k + 1]] for k in range(num_parts)]


def read_shp(path: Path | str) -> ShpFile:
    path = Path(path)
    data = path.read_bytes()
    if len(data) < 100 or struct.unpack_from(">i", data, 0)[0] != 9994:
        raise ValueError(f"{path}: not a shapefile (bad file code)")
    file_len = struct.unpack_from(">i", data, 24)[0] * 2
    shape_type = struct.unpack_from("<i", data, 32)[0]
    xmin, ymin, xmax, ymax = struct.unpack_from("<4d", data, 36)
    records: List[ShpRecord] = []
    off = 100
    while off + 8 <= min(file_len, len(data)):
        rec_no, content_len = struct.unpack_from(">ii", data, off)
        off += 8
        content = data[off:off + content_len * 2]
        off += content_len * 2
        if len(content) < 4:
            break
        stype = struct.unpack_from("<i", content, 0)[0]
        rec = ShpRecord(number=rec_no, shape_type=stype)
        if stype in _POLYGONS + _POLYLINES:
            rec.parts = _read_multipart(content)
        elif stype in _POINTS:
            x, y = struct.unpack_from("<2d", content, 4)
            rec.point = (x, y)
        records.append(rec)

    shp = ShpFile(shape_type=shape_type, bbox=(xmin, ymin, xmax, ymax),
                  records=records)
    dbf = path.with_suffix(".dbf")
    if dbf.exists():
        try:
            shp.fields, shp.attributes = read_dbf(dbf)
        except Exception:
            pass
    return shp


def read_dbf(path: Path | str):
    """dBase III field names + records (text decoded, numerics parsed)."""
    data = Path(path).read_bytes()
    n_rec = struct.unpack_from("<i", data, 4)[0]
    hdr_size, rec_size = struct.unpack_from("<hh", data, 8)
    fields = []   # (name, type, length)
    off = 32
    while off < hdr_size - 1 and data[off] != 0x0D:
        raw = data[off:off + 32]
        name = raw[:11].split(b"\x00")[0].decode("ascii", "replace")
        ftype = chr(raw[11])
        flen = raw[16]
        fields.append((name, ftype, flen))
        off += 32
    names = [f[0] for f in fields]
    records: List[Dict[str, object]] = []
    off = hdr_size
    for _ in range(n_rec):
        if off + rec_size > len(data):
            break
        row = data[off:off + rec_size]
        off += rec_size
        if row[:1] == b"*":      # deleted
            continue
        vals: Dict[str, object] = {}
        p = 1
        for name, ftype, flen in fields:
            cell = row[p:p + flen]
            p += flen
            text = cell.decode("latin-1", "replace").strip()
            if ftype in ("N", "F"):
                try:
                    vals[name] = float(text) if ("." in text or "e" in text.lower()) else int(text)
                except ValueError:
                    vals[name] = None
            else:
                vals[name] = text
        records.append(vals)
    return names, records


# ---------------------------------------------------------------------------
# Minimal writers (polygon / point shapefiles + dBase III attribute tables).
# Enough for the documented inter-tool contracts: building-footprint inputs
# (reference 2_shpCutter.py) and the DEM point shapefile drop-folder artifact
# (reference dem_tif_to_shp.py:207).
# ---------------------------------------------------------------------------


def _shp_header(shape_type: int, bbox, file_len_bytes: int) -> bytes:
    hdr = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0)
    hdr += struct.pack(">i", file_len_bytes // 2)
    hdr += struct.pack("<ii", 1000, shape_type)
    hdr += struct.pack("<4d", *bbox)
    hdr += struct.pack("<4d", 0.0, 0.0, 0.0, 0.0)   # z/m ranges
    return hdr


def write_dbf(path: Path | str, fields, records) -> None:
    """dBase III table.  fields: [(name, 'N'|'C', length, decimals)]."""
    rec_size = 1 + sum(f[2] for f in fields)
    hdr_size = 32 + 32 * len(fields) + 1
    out = bytearray()
    out += struct.pack("<B3BIHH20x", 0x03, 24, 1, 1, len(records),
                       hdr_size, rec_size)
    for name, ftype, flen, fdec in fields:
        out += struct.pack("<11sc4xBB14x", name.encode("ascii")[:11],
                           ftype.encode("ascii"), flen, fdec)
    out += b"\x0D"
    for rec in records:
        out += b" "
        for name, ftype, flen, fdec in fields:
            v = rec.get(name, "")
            if ftype == "N":
                text = (f"{float(v):.{fdec}f}" if fdec else str(int(v)))
                out += text.rjust(flen)[:flen].encode("ascii")
            else:
                out += str(v).ljust(flen)[:flen].encode("latin-1", "replace")
    out += b"\x1A"
    Path(path).write_bytes(bytes(out))


def _write_shp_pair(path: Path, shape_type: int, contents: List[bytes],
                    bbox, fields=None, records=None) -> None:
    body = b""
    shx = b""
    off_words = 50
    for i, content in enumerate(contents):
        body += struct.pack(">ii", i + 1, len(content) // 2) + content
        shx += struct.pack(">ii", off_words, len(content) // 2)
        off_words += 4 + len(content) // 2
    path = Path(path)
    path.write_bytes(_shp_header(shape_type, bbox, 100 + len(body)) + body)
    path.with_suffix(".shx").write_bytes(
        _shp_header(shape_type, bbox, 100 + len(shx)) + shx)
    if fields is not None:
        write_dbf(path.with_suffix(".dbf"), fields, records or [])


def write_polygon_shp(path: Path | str, polygons,
                      heights: Optional[List[float]] = None,
                      height_field: str = "height") -> None:
    """Polygon shapefile (+ .shx/.dbf).  polygons: list of closed rings
    [(x, y), ...]; heights fill a numeric attribute column."""
    contents = []
    xs_all, ys_all = [], []
    for ring in polygons:
        ring = [(float(p[0]), float(p[1])) for p in ring]
        if ring[0] != ring[-1]:
            ring = ring + [ring[0]]
        # shapefile outer rings are clockwise (negative shoelace area)
        if ring_area(ring) > 0:
            ring = ring[::-1]
        xs = [p[0] for p in ring]
        ys = [p[1] for p in ring]
        xs_all += xs
        ys_all += ys
        content = struct.pack("<i4d", 5, min(xs), min(ys), max(xs), max(ys))
        content += struct.pack("<ii", 1, len(ring))
        content += struct.pack("<i", 0)
        for x, y in ring:
            content += struct.pack("<2d", x, y)
        contents.append(content)
    bbox = (min(xs_all), min(ys_all), max(xs_all), max(ys_all))
    fields = [(height_field, "N", 18, 4), ("id", "N", 9, 0)]
    records = [{height_field: (heights[i] if heights else 0.0), "id": i}
               for i in range(len(polygons))]
    _write_shp_pair(Path(path), 5, contents, bbox, fields, records)


def write_point_shp(path: Path | str, points,
                    values: Optional[List[float]] = None,
                    value_field: str = "elevation") -> None:
    """Point shapefile (+ .shx/.dbf) — the DEM drop-folder artifact format
    (reference dem_tif_to_shp.py:207)."""
    contents = [struct.pack("<i2d", 1, float(x), float(y)) for x, y in points]
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    bbox = (min(xs), min(ys), max(xs), max(ys))
    fields = [(value_field, "N", 18, 4)]
    records = [{value_field: (values[i] if values is not None else 0.0)}
               for i in range(len(points))]
    _write_shp_pair(Path(path), 1, contents, bbox, fields, records)


def ring_area(ring: List[Tuple[float, float]]) -> float:
    """Signed shoelace area (negative = clockwise = shapefile outer ring)."""
    a = 0.0
    n = len(ring)
    for i in range(n - 1):
        x0, y0 = ring[i]
        x1, y1 = ring[i + 1]
        a += x0 * y1 - x1 * y0
    return 0.5 * a


def polygon_defects(rec: ShpRecord) -> List[str]:
    """Degeneracy audit of one polygon record — the pure-python subset of
    the reference shpTester checks (null/empty/too few points/ring not
    closed/zero area)."""
    issues: List[str] = []
    if rec.shape_type == 0:
        return ["null"]
    if not rec.parts:
        return ["empty"]
    for k, ring in enumerate(rec.parts):
        if len(ring) < 4:
            issues.append(f"part{k}:too_few_points")
            continue
        if ring[0] != ring[-1]:
            issues.append(f"part{k}:ring_not_closed")
        if abs(ring_area(ring)) <= 0.0:
            issues.append(f"part{k}:zero_area")
    return issues
