"""Local-grid <-> geographic transforms for postprocessing.

Clean-room equivalent of the TransformModel in tools_core/vtk2nc_new.py
(:393-468): the solver grid lives in a rotated, origin-shifted UTM frame.
Conventions match pre/buildbc.py EXACTLY (and the reference pair
1_buildBC.py:999-1058 / vtk2nc_new.py:403-424):

  * forward (lonlat -> local): project to UTM, rotate by +rotate_deg about
    the PIVOT (the projected cut-window centroid), subtract the rotated
    window's min corner;
  * inverse (local -> lonlat): add the origin, rotate by -rotate_deg about
    the pivot, unproject;
  * winds: the boundary CSV carries components in the ROTATED local frame
    (buildbc rotates them); derotate_winds applies R(-rotate_deg) to
    recover east/north on export (reference vtk_avg_to_utm_asl_nc.py:496).

Consistency is pinned by tests/test_pre_post_tools.py round-trip tests and
the buildbc cross-check.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..pre.utm import lonlat_to_utm, utm_to_lonlat


@dataclass
class TransformModel:
    zone: int
    northern: bool
    rotate_deg: float
    pivot: Tuple[float, float]        # UTM pivot (projected bbox centroid)
    origin_rot: Tuple[float, float]   # rotated-frame min corner (local 0,0)

    @classmethod
    def from_deck(cls, deck, si_size_xy: Tuple[float, float] = None) -> "TransformModel":
        lon_pair = deck.get_pair("cut_lon_manual")
        lat_pair = deck.get_pair("cut_lat_manual")
        if lon_pair is None or lat_pair is None:
            raise ValueError("deck missing cut_lon_manual/cut_lat_manual")
        crs = (deck.get_text("utm_crs") or "").upper()
        if crs.startswith("EPSG:"):
            code = int(crs.split(":")[1])
            zone = code % 100
            northern = 32600 <= code < 32700
        else:
            zone = None
            northern = 0.5 * sum(lat_pair) >= 0
        if zone is None:
            from ..pre.utm import utm_zone_for

            zone = utm_zone_for(0.5 * sum(lon_pair))
        rotate_deg = deck.get_float("rotate_deg", 0.0) or 0.0

        # project the four window corners; pivot = centroid, origin = min
        # corner of the rotated window (identical to pre/buildbc.py)
        lons = np.array([lon_pair[0], lon_pair[1], lon_pair[1], lon_pair[0]])
        lats = np.array([lat_pair[0], lat_pair[0], lat_pair[1], lat_pair[1]])
        xs, ys = lonlat_to_utm(lons, lats, zone=zone)
        cx, cy = float(xs.mean()), float(ys.mean())
        th = np.radians(rotate_deg)
        xr = np.cos(th) * (xs - cx) - np.sin(th) * (ys - cy) + cx
        yr = np.sin(th) * (xs - cx) + np.cos(th) * (ys - cy) + cy
        return cls(zone=zone, northern=northern, rotate_deg=rotate_deg,
                   pivot=(cx, cy),
                   origin_rot=(float(xr.min()), float(yr.min())))

    def _rotate(self, x, y, deg):
        th = np.radians(deg)
        c, s = np.cos(th), np.sin(th)
        xr = c * (np.asarray(x) - self.pivot[0]) - s * (np.asarray(y) - self.pivot[1])
        yr = s * (np.asarray(x) - self.pivot[0]) + c * (np.asarray(y) - self.pivot[1])
        return xr + self.pivot[0], yr + self.pivot[1]

    def local_to_lonlat(self, x, y):
        """Local rotated meters -> (lon, lat)."""
        x_rot = np.asarray(x) + self.origin_rot[0]
        y_rot = np.asarray(y) + self.origin_rot[1]
        ux, uy = self._rotate(x_rot, y_rot, -self.rotate_deg)
        return utm_to_lonlat(ux, uy, self.zone, self.northern)

    def lonlat_to_local(self, lon, lat):
        ux, uy = lonlat_to_utm(np.asarray(lon), np.asarray(lat), zone=self.zone)
        xr, yr = self._rotate(ux, uy, self.rotate_deg)
        return xr - self.origin_rot[0], yr - self.origin_rot[1]

    def derotate_winds(self, u, v):
        """Rotated-local-frame winds -> east/north components (R(-deg))."""
        th = np.radians(self.rotate_deg)
        ue = np.cos(th) * np.asarray(u) + np.sin(th) * np.asarray(v)
        vn = -np.sin(th) * np.asarray(u) + np.cos(th) * np.asarray(v)
        return ue, vn
