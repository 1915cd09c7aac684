"""WRF/NetCDF ingestion for luwbc.

Clean-room equivalent of the heavy half of the reference's 1_buildBC stage
(bridge_core/1_buildBC.py:64-354): dim normalization + destaggering of WRF
winds, AGL height derivation from the geopotential, boundary sample
extraction, then the shared projection/rotation/grid path in pre/buildbc.py.

Two loaders: xarray (NetCDF4/HDF5, when installed) and a scipy.io fallback
for classic NetCDF-3 files, so the NWP path works without the GIS stack.

A copy of `latticeurbanwind_tpu/pre/wrf_ingest.py` but for the scipy
loader, which copies every array out of the memory map before it closes the
file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

Var = Tuple[Tuple[str, ...], np.ndarray]   # (dims, values)


def _destagger(arr, axis):
    sl0 = [slice(None)] * arr.ndim
    sl1 = [slice(None)] * arr.ndim
    sl0[axis] = slice(None, -1)
    sl1[axis] = slice(1, None)
    return 0.5 * (arr[tuple(sl0)] + arr[tuple(sl1)])


def load_nc_vars(nc_path: Path) -> Dict[str, Var]:
    """{name: (dims, values)} via xarray, falling back to scipy NetCDF-3."""
    try:
        import xarray as xr

        ds = xr.open_dataset(nc_path)
        out = {}
        for name in list(ds.variables):
            v = ds[name]
            out[name] = (tuple(v.dims), np.asarray(v.values))
        return out
    except ImportError:
        pass
    from scipy.io import netcdf_file

    # mmap keeps multi-GB NWP files off the heap (the reference streams big
    # NetCDFs through dask-chunked xarray, 1_buildBC.py:1214-1217); only the
    # first time index of each variable is materialized.
    # The arrays are copied out of the map in a scope of their own, so that
    # no variable still refers to it when the file closes (scipy warns, and
    # keeps the map open, otherwise).
    ds = netcdf_file(str(nc_path), "r", mmap=True)
    try:
        out = {k: _copy_first_time(v) for k, v in ds.variables.items()}
    finally:
        ds.close()
    return out


def _copy_first_time(v) -> Var:
    """(dims, a copy of the values) of a NetCDF variable, only the first
    time index of one whose leading dimension is time."""
    dims = tuple(v.dimensions)
    if dims and dims[0].lower() in ("time", "times") and v.data.ndim > 0:
        return dims, np.array(v[0])[None]
    return dims, np.array(v[:])


def _pick_time(var: Optional[Var]) -> Optional[np.ndarray]:
    if var is None:
        return None
    dims, vals = var
    if dims and dims[0].lower() in ("time", "times"):
        return vals[0]
    return vals


def build_from_wrf(deck_path: Path) -> int:
    from ..cli.inspect_tools import resolve_nc_path
    from ..deck import load_deck

    deck_path = Path(deck_path)
    deck = load_deck(deck_path)
    nc = resolve_nc_path(deck_path.parent, deck)
    ds = load_nc_vars(nc)
    print(f"[luwbc] ingesting {nc.name} ({len(ds)} variables)")

    def first(names) -> Optional[Var]:
        for n in names:
            if n in ds:
                return ds[n]
        return None

    lon = _pick_time(first(["XLONG", "lon", "longitude", "XLON"]))
    lat = _pick_time(first(["XLAT", "lat", "latitude"]))
    if lon is None or lat is None:
        print("[luwbc] ERROR: no lon/lat coordinates found in the NetCDF")
        return 1
    u = _pick_time(first(["U", "u", "ua"]))
    v = _pick_time(first(["V", "v", "va"]))
    w = _pick_time(first(["W", "w", "wa"]))
    if u is None or v is None:
        print("[luwbc] ERROR: no U/V wind fields found")
        return 1

    # destagger WRF Arakawa-C grids (west_east_stag / south_north_stag /
    # bottom_top_stag; reference 1_buildBC.py:64-220)
    if u.shape[-1] == lon.shape[-1] + 1:
        u = _destagger(u, -1)
    if v.shape[-2] == lat.shape[-2] + 1:
        v = _destagger(v, -2)
    if w is not None and w.shape[0] == u.shape[0] + 1:
        w = _destagger(w, 0)
    if w is None:
        w = np.zeros_like(u)

    # AGL heights from the geopotential (PH+PHB)/g - HGT (1_buildBC.py:237ff)
    ph = _pick_time(first(["PH"]))
    phb = _pick_time(first(["PHB"]))
    hgt = _pick_time(first(["HGT"]))
    nz = u.shape[0]
    if ph is not None and phb is not None:
        gp = (ph + phb) / 9.81
        z_full = _destagger(gp, 0)
        z_agl = z_full - (hgt[None] if hgt is not None else 0.0)
    else:
        z_agl = np.linspace(10.0, 1500.0, nz)[:, None, None] * np.ones_like(u)

    T = _pick_time(first(["T2", "T", "temp"]))
    if T is not None:
        if T.ndim == u.ndim - 1:
            T = np.broadcast_to(T[None], u.shape).copy()
        elif T.ndim != u.ndim:
            T = None
        if T is not None and np.nanmax(T) < 200.0:
            T = T + 300.0  # WRF perturbation potential temperature convention

    # 1-D AGL level ladder = domain mean of the per-column AGL heights
    # (the reference's height_agl_1d coordinate, 1_buildBC.py:237-354)
    z_levels = np.nanmean(np.broadcast_to(z_agl, u.shape).reshape(u.shape[0], -1),
                          axis=1)

    # NaN columns: vertical forward fill (reference _forward_fill_whole_layer)
    for arr in (u, v, w) + ((T,) if T is not None else ()):
        if np.isnan(arr).any():
            for k in range(1, arr.shape[0]):
                lay = arr[k]
                lay[np.isnan(lay)] = arr[k - 1][np.isnan(lay)]
            arr[np.isnan(arr)] = 0.0

    from .buildbc import build_structured

    build_structured(deck_path, lon, lat, z_levels, u, v, w, T)
    return 0
