"""Probe deck-syntax parsing and resolution.

Contract (reference: setup.cpp:1435-1615 split_probe_tokens /
parse_probe_offset / parse_probe_request / make_probe_file_stem):

  probes = [lon:lat, center, lon:lat NNE, lon:lat N100E50.5]

  * `lon:lat` anchors; `center`/`centre` uses the domain-center lon/lat.
  * bare NSEW letters after the anchor = per-letter GRID-CELL offsets;
  * letters followed by numbers = METER offsets (non-negative magnitudes);
  * probe CSV file stem = `<lon>_<lat>[_<OFFSET>]` with prefix, deduplicated
    with `_2`, `_3`, ... suffixes.

Resolution: lon/lat -> local meters via the TransformModel, snap to the
nearest cell column, gather all non-solid z levels; heights are AGL relative
to the first fluid cell.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..lbm.state import TYPE_S
from .probes import GridProbe


@dataclass
class ProbeOffset:
    mode: str = "none"        # none | grid | meters
    east_cells: int = 0
    north_cells: int = 0
    east_m: float = 0.0
    north_m: float = 0.0
    label: str = ""


@dataclass
class ProbeRequest:
    raw: str = ""
    lon: float = 0.0
    lat: float = 0.0
    uses_center: bool = False
    offset: ProbeOffset = field(default_factory=ProbeOffset)


def split_probe_tokens(raw: str) -> List[str]:
    s = raw.strip()
    lb, rb = s.find("["), s.rfind("]")
    if lb >= 0 and rb > lb:
        s = s[lb + 1:rb]
    out, token, quote = [], "", ""
    for ch in s:
        if quote:
            token += ch
            if ch == quote:
                quote = ""
            continue
        if ch in "\"'":
            quote = ch
            token += ch
            continue
        if ch == ",":
            if token.strip():
                out.append(token.strip())
            token = ""
            continue
        token += ch
    if token.strip():
        out.append(token.strip())
    return out


def parse_probe_offset(raw: str) -> ProbeOffset:
    s = re.sub(r"\s+", "", raw).upper()
    off = ProbeOffset(label=s)
    if not s:
        return off
    if not any(c.isdigit() for c in s):
        off.mode = "grid"
        for ch in s:
            if ch == "N":
                off.north_cells += 1
            elif ch == "S":
                off.north_cells -= 1
            elif ch == "E":
                off.east_cells += 1
            elif ch == "W":
                off.east_cells -= 1
            else:
                raise ValueError("grid offset can only contain N/S/E/W")
        return off
    off.mode = "meters"
    i = 0
    while i < len(s):
        d = s[i]
        if d not in "NSEW":
            raise ValueError("meter offset must use N/S/E/W followed by a number")
        # plain decimals only: 'E' doubles as a direction letter, so
        # exponent notation would be ambiguous (N100E50.5 = N100 + E50.5)
        m = re.match(r"[0-9]*\.?[0-9]+", s[i + 1:])
        if not m:
            raise ValueError("meter offset is missing a numeric value after direction")
        val = float(m.group(0))
        if d == "N":
            off.north_m += val
        elif d == "S":
            off.north_m -= val
        elif d == "E":
            off.east_m += val
        else:
            off.east_m -= val
        i += 1 + m.end()
    return off


def parse_probe_request(token: str) -> ProbeRequest:
    req = ProbeRequest(raw=token.strip())
    t = req.raw
    if not t:
        raise ValueError("empty probe token")
    if t[0] in "\"'":
        close = t.find(t[0], 1)
        if close < 0:
            raise ValueError("quoted probe token is missing the closing quote")
        inner, rest = t[1:close], t[close + 1:].strip()
        if inner.strip().lower() not in ("center", "centre"):
            raise ValueError("quoted probe token only supports center/centre")
        req.uses_center = True
        req.offset = parse_probe_offset(rest)
        return req
    low = t.lower()
    for key in ("center", "centre"):
        if low.startswith(key):
            req.uses_center = True
            req.offset = parse_probe_offset(t[len(key):])
            return req
    if ":" not in t:
        raise ValueError("probe must be lon:lat, center, or centre")
    lon_text, rest = t.split(":", 1)
    req.lon = float(lon_text.strip())
    m = re.match(r"\s*[-+0-9.eE]+", rest)
    if not m:
        raise ValueError("invalid probe latitude")
    req.lat = float(m.group(0))
    req.offset = parse_probe_offset(rest[m.end():])
    return req


def _trim_num(v: float) -> str:
    s = f"{v:.6f}".rstrip("0").rstrip(".")
    return s if s else "0"


def _sanitize(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.+-]", "_", s)


def probe_file_stem(req: ProbeRequest, center_lonlat: Tuple[float, float],
                    prefix: str = "") -> str:
    lon = center_lonlat[0] if req.uses_center else req.lon
    lat = center_lonlat[1] if req.uses_center else req.lat
    stem = f"{_trim_num(lon)}_{_trim_num(lat)}"
    if req.offset.label:
        stem += "_" + _sanitize(req.offset.label)
    if prefix:
        stem = _sanitize(prefix) + stem
    return _sanitize(stem)


def resolve_probes(
    tokens_raw: str,
    *,
    model,                       # post.transform.TransformModel
    center_lonlat: Tuple[float, float],
    flags: np.ndarray,           # (Z, Y, X)
    cell_m: float,
    si_size_xy: Tuple[float, float],
    vtk_prefix: str = "",
) -> List[GridProbe]:
    """Parse + resolve the deck's probes value into GridProbe columns."""
    Z, Y, X = flags.shape
    probes: List[GridProbe] = []
    used = set()
    for token in split_probe_tokens(tokens_raw):
        try:
            req = parse_probe_request(token)
        except ValueError as e:
            print(f"| WARNING: probe '{token}' ignored: {e}")
            continue
        lon = center_lonlat[0] if req.uses_center else req.lon
        lat = center_lonlat[1] if req.uses_center else req.lat
        x_si, y_si = model.lonlat_to_local(np.array([lon]), np.array([lat]))
        x_si, y_si = float(x_si[0]), float(y_si[0])
        x_si += req.offset.east_m
        y_si += req.offset.north_m
        if not (0.0 <= x_si <= si_size_xy[0] and 0.0 <= y_si <= si_size_xy[1]):
            print(f"| WARNING: probe '{token}' ignored: base point is outside "
                  "CFD domain")
            continue
        xi = int(np.clip(round(x_si / cell_m), 0, X - 1)) + req.offset.east_cells
        yi = int(np.clip(round(y_si / cell_m), 0, Y - 1)) + req.offset.north_cells
        if not (0 <= xi < X and 0 <= yi < Y):
            print(f"| WARNING: probe '{token}' ignored: offset leaves the domain")
            continue
        zs = [int(z) for z in range(Z) if not (flags[z, yi, xi] & TYPE_S)]
        if not zs:
            print(f"| WARNING: probe '{token}' ignored: resolved column has "
                  "no fluid cell")
            continue
        z0 = zs[0]
        heights = [((z - z0) + 0.5) * cell_m for z in zs]
        stem = probe_file_stem(req, center_lonlat, vtk_prefix)
        if stem in used:
            k = 2
            while f"{stem}_{k}" in used:
                k += 1
            stem = f"{stem}_{k}"
        used.add(stem)
        probes.append(GridProbe(file_stem=stem, x=xi, y=yi,
                                z_indices=zs, heights_si=heights))
    return probes
