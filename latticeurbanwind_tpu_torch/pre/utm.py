"""Pure-math UTM projection (WGS84, Karney/Krüger series) — replaces pyproj.

Clean-room equivalent of bridge_core/auto_UTM.py (zone/EPSG derivation) plus
the forward/inverse transverse-Mercator projection itself, accurate to
sub-millimeter within a zone — validated against published UTM test points
in tests/test_pre_tools.py.
"""

from __future__ import annotations

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2.0 - _F)
_N = _F / (2.0 - _F)

# Krüger series coefficients (order n^4 — mm accuracy)
_ALPHA = (
    _N / 2 - 2 * _N ** 2 / 3 + 5 * _N ** 3 / 16 + 41 * _N ** 4 / 180,
    13 * _N ** 2 / 48 - 3 * _N ** 3 / 5 + 557 * _N ** 4 / 1440,
    61 * _N ** 3 / 240 - 103 * _N ** 4 / 140,
    49561 * _N ** 4 / 161280,
)
_BETA = (
    _N / 2 - 2 * _N ** 2 / 3 + 37 * _N ** 3 / 96 - _N ** 4 / 360,
    _N ** 2 / 48 + _N ** 3 / 15 - 437 * _N ** 4 / 1440,
    17 * _N ** 3 / 480 - 37 * _N ** 4 / 840,
    4397 * _N ** 4 / 161280,
)
_A_CAP = _A / (1 + _N) * (1 + _N ** 2 / 4 + _N ** 4 / 64)


def utm_zone_for(lon: float) -> int:
    return int((lon + 180.0) // 6.0) % 60 + 1


def utm_epsg_for(lon: float, lat: float) -> int:
    """EPSG code 326xx (N) / 327xx (S)."""
    zone = utm_zone_for(lon)
    return (32600 if lat >= 0 else 32700) + zone


def lonlat_to_utm(lon, lat, zone: int = None):
    """(easting, northing) in meters for the given/derived zone."""
    lon = np.asarray(lon, dtype=np.float64)
    lat = np.asarray(lat, dtype=np.float64)
    if zone is None:
        zone = utm_zone_for(float(np.mean(lon)))
    lon0 = np.radians(zone * 6.0 - 183.0)
    phi = np.radians(lat)
    lam = np.radians(lon) - lon0

    # conformal latitude
    e = np.sqrt(_E2)
    t = np.sinh(np.arctanh(np.sin(phi)) - e * np.arctanh(e * np.sin(phi)))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.hypot(t, np.cos(lam)))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j, (a_j) in enumerate(_ALPHA, start=1):
        xi = xi + a_j * np.sin(2 * j * xi_p) * np.cosh(2 * j * eta_p)
        eta = eta + a_j * np.cos(2 * j * xi_p) * np.sinh(2 * j * eta_p)

    easting = _K0 * _A_CAP * eta + 500000.0
    northing = _K0 * _A_CAP * xi
    northing = np.where(lat < 0, northing + 10000000.0, northing)
    return easting, northing


def utm_to_lonlat(easting, northing, zone: int, northern: bool = True):
    """Inverse UTM (easting, northing, zone) -> (lon, lat) degrees."""
    easting = np.asarray(easting, dtype=np.float64)
    northing = np.asarray(northing, dtype=np.float64)
    x = easting - 500000.0
    y = np.where(northern, northing, northing - 10000000.0) if not northern \
        else northing
    xi = y / (_K0 * _A_CAP)
    eta = x / (_K0 * _A_CAP)

    xi_p = xi.copy()
    eta_p = eta.copy()
    for j, b_j in enumerate(_BETA, start=1):
        xi_p = xi_p - b_j * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b_j * np.cos(2 * j * xi) * np.sinh(2 * j * eta)

    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    # iterate to geodetic latitude
    e = np.sqrt(_E2)
    phi = chi.copy()
    for _ in range(6):
        t = np.sinh(np.arctanh(np.sin(phi)) - e * np.arctanh(e * np.sin(phi)))
        phi = phi - (np.arctan(t) - chi) / np.maximum(
            1.0 - _E2 * np.cos(phi) ** 2, 1e-12)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    lon0 = zone * 6.0 - 183.0
    return np.degrees(lam) + lon0, np.degrees(phi)
