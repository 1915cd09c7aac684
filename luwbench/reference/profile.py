"""Profile-mode boundary conditions: AGL wind-speed profile -> flags/velocity.

Clean-room equivalent of the reference's profile pipeline
(reference: setup.cpp:3672-3729 profile.dat ingestion, :5861-5912 cubic
interpolation into a 0.1 m AGL table, :5913-5995 init + boundary builders,
:6009-6012 direction convention dir = (-sin a, -cos a)).

All field construction is vectorized numpy over the whole lattice.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .state import TYPE_E, TYPE_S

PROFILE_DZ_SI = 0.1  # AGL table resolution in meters


def load_profile_dat(path: Path | str) -> Tuple[np.ndarray, np.ndarray]:
    """Read `z u` sample pairs; tolerant of headers/commas/tabs."""
    z_vals, u_vals = [], []
    for line in Path(path).read_text().splitlines():
        parts = line.replace(",", " ").split()
        if len(parts) < 2:
            continue
        try:
            z, u = float(parts[0]), float(parts[1])
        except ValueError:
            continue
        z_vals.append(z)
        u_vals.append(u)
    z = np.asarray(z_vals, dtype=np.float64)
    u = np.asarray(u_vals, dtype=np.float64)
    order = np.argsort(z, kind="stable")
    z, u = z[order], u[order]
    # drop duplicate heights, keeping the last value
    keep = np.ones(len(z), dtype=bool)
    keep[:-1] = np.abs(np.diff(z)) >= 1e-6
    return z[keep], u[keep]


def _hermite_cubic(z: np.ndarray, u: np.ndarray, zq: np.ndarray) -> np.ndarray:
    """Monotone-ish cubic Hermite with central-difference slopes (clamped at
    the table ends) — matches the reference's interpolate_profile_cubic."""
    zq = np.asarray(zq, dtype=np.float64)
    out = np.empty_like(zq)
    out[zq <= z[0]] = u[0]
    out[zq >= z[-1]] = u[-1]
    inside = (zq > z[0]) & (zq < z[-1])
    q = zq[inside]
    i1 = np.searchsorted(z, q, side="right") - 1
    i2 = np.minimum(i1 + 1, len(z) - 1)
    z0, z1 = z[i1], z[i2]
    h = z1 - z0
    t = np.where(h > 0, (q - z0) / np.where(h > 0, h, 1.0), 0.0)

    def slope(i):
        i = np.asarray(i)
        s = np.empty(i.shape)
        first = i == 0
        last = i >= len(z) - 1
        mid = ~(first | last)
        s[first] = (u[1] - u[0]) / max(z[1] - z[0], 1e-30)
        s[last] = (u[-1] - u[-2]) / max(z[-1] - z[-2], 1e-30)
        im = i[mid]
        s[mid] = (u[im + 1] - u[im - 1]) / (z[im + 1] - z[im - 1])
        return s

    m0 = slope(i1) * h
    m1 = slope(i2) * h
    t2 = t * t
    t3 = t2 * t
    out[inside] = (
        (2 * t3 - 3 * t2 + 1) * u[i1] + (t3 - 2 * t2 + t) * m0
        + (-2 * t3 + 3 * t2) * u[i2] + (t3 - t2) * m1
    )
    return out


@dataclass
class ProfileTable:
    """Dense 0.1 m AGL lookup of wind speed, SI."""

    u_si: np.ndarray          # (n+1,) speeds at i*0.1 m AGL
    dz_si: float = PROFILE_DZ_SI

    @classmethod
    def build(cls, z_samples: np.ndarray, u_samples: np.ndarray,
              table_top_si: float, domain_agl_si: Optional[float] = None) -> "ProfileTable":
        z = np.asarray(z_samples, dtype=np.float64).copy()
        u = np.asarray(u_samples, dtype=np.float64)
        if len(z) < 2:
            raise ValueError("profile needs at least two samples")
        # normalized-z convention: z in [0, ~1] scaled by the domain AGL height
        if domain_agl_si is not None and domain_agl_si > 1.0 and z[-1] <= 1.5:
            z = z * domain_agl_si
        top = max(table_top_si, PROFILE_DZ_SI)
        steps = int(np.ceil(top / PROFILE_DZ_SI))
        zq = np.minimum(np.arange(steps + 1) * PROFILE_DZ_SI, top)
        vals = np.maximum(_hermite_cubic(z, u, zq), 0.0)
        return cls(u_si=vals.astype(np.float64))

    @property
    def max_u(self) -> float:
        return float(self.u_si.max())

    def speed_at_agl(self, z_agl_si: np.ndarray) -> np.ndarray:
        """Nearest-index lookup, 0 at/below ground (reference profile_speed_lbmu)."""
        z = np.maximum(np.asarray(z_agl_si, dtype=np.float64), 0.0)
        idx = np.clip(np.rint(z / self.dz_si).astype(np.int64), 0, len(self.u_si) - 1)
        out = self.u_si[idx]
        return np.where(np.asarray(z_agl_si) <= 0.0, 0.0, out)


def downstream_from_direction(dir_x: float, dir_y: float) -> str:
    """Dominant-axis downstream face from a flow direction."""
    if abs(dir_x) >= abs(dir_y):
        return "+x" if dir_x >= 0.0 else "-x"
    return "+y" if dir_y >= 0.0 else "-y"


def direction_from_angle(angle_deg: float) -> Tuple[float, float]:
    """Meteorological angle -> unit flow direction (-sin a, -cos a)."""
    a = np.deg2rad(angle_deg)
    return float(-np.sin(a)), float(-np.cos(a))


def profile_boundary_fields(
    shape: Tuple[int, int, int],
    *,
    table: ProfileTable,
    cell_m: float,
    u_scale: float,             # lbm_ref_u / si_ref_u
    ground_z_lbm,               # scalar or (Y, X) ground height in lattice coords
    dir_x: float,
    dir_y: float,
    solid: Optional[np.ndarray] = None,   # (Z,Y,X) building/terrain mask
    downstream_bc: str = "+y",
    downstream_open: bool = False,
    side_ref_z_cap: int = -1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (flags, u) for a profile case: z=0 solid ground, below-terrain
    solid, outer shell TYPE_E with profile velocities (side faces capped at
    the core top when the sponge extends the grid), interior initialized with
    the same profile."""
    Z, Y, X = shape
    zc = np.arange(Z, dtype=np.float64) + 0.5          # cell centers, lattice
    ground = np.broadcast_to(np.asarray(ground_z_lbm, dtype=np.float64), (Y, X))

    # AGL height per cell in SI (lattice z -> SI via cell_m; position(z) = z+0.5
    # relative to the box origin, ground already in the same frame)
    pos_z = zc[:, None, None]                           # (Z,1,1)
    agl_si = (pos_z - ground[None]) * cell_m            # (Z,Y,X)
    speed_si = table.speed_at_agl(agl_si)
    speed_lbm = speed_si * u_scale

    flags = np.zeros(shape, dtype=np.uint8)
    if solid is not None:
        flags |= np.where(solid, np.uint8(TYPE_S), np.uint8(0))
    below_ground = pos_z <= ground[None]
    flags[below_ground] = TYPE_S
    flags[0, :, :] = TYPE_S                             # ground plate

    u = np.zeros((3, Z, Y, X), dtype=np.float32)
    u[0] = (dir_x * speed_lbm).astype(np.float32)
    u[1] = (dir_y * speed_lbm).astype(np.float32)
    solid_mask = (flags & TYPE_S) != 0
    u[:, solid_mask] = 0.0

    # outer shell -> TYPE_E (except solids)
    boundary = np.zeros(shape, dtype=bool)
    boundary[:, :, 0] = boundary[:, :, -1] = True
    boundary[:, 0, :] = boundary[:, -1, :] = True
    boundary[-1, :, :] = True
    boundary[0, :, :] = False                           # ground handled above
    emask = boundary & ~solid_mask
    flags[emask] |= TYPE_E

    # side boundary velocities above the core top evaluate at the cap height
    if side_ref_z_cap >= 0:
        side = np.zeros(shape, dtype=bool)
        side[:, :, 0] = side[:, :, -1] = True
        side[:, 0, :] = side[:, -1, :] = True
        zcap_agl_si = ((side_ref_z_cap + 0.5) - ground[None]) * cell_m
        cap_speed = (table.speed_at_agl(zcap_agl_si) * u_scale).astype(np.float32)
        above = np.zeros(shape, dtype=bool)
        above[side_ref_z_cap + 1:, :, :] = True
        sel = side & above & emask
        u[0][sel] = (dir_x * np.broadcast_to(cap_speed, shape))[sel]
        u[1][sel] = (dir_y * np.broadcast_to(cap_speed, shape))[sel]

    # downstream open face: keep TYPE_E but zero prescribed velocity region?
    # The reference leaves downstream cells without a fixed velocity only when
    # downstream_open_face is set; they are still TYPE_E cells.
    if downstream_open:
        ds = np.zeros(shape, dtype=bool)
        if downstream_bc == "+x":
            ds[:, :, -1] = True
        elif downstream_bc == "-x":
            ds[:, :, 0] = True
        elif downstream_bc == "+y":
            ds[:, -1, :] = True
        elif downstream_bc == "-y":
            ds[:, 0, :] = True
        sel = ds & emask
        u[0][sel] = 0.0
        u[1][sel] = 0.0
        u[2][sel] = 0.0

    return flags, u
