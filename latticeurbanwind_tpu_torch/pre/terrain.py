"""Terrain surface interpolation: IDW and ordinary kriging on DEM points.

Clean-room equivalent of the reference's terrain voxelization backends
(reference: bridge_core/3_voxelization.py:340-790 CPU paths and
bridge_core/terr_voxel_gpu.py numba.cuda kriging kernel).  The device
analog of the CUDA kriging kernel is one batched program: per-target
K-nearest DEM neighbors (numpy, on the host), exponential-variogram
ordinary-kriging systems solved as one batched (K+1)x(K+1) float32 solve on
the torch device.  A system that does not solve gives its target to IDW.

A copy of `latticeurbanwind_tpu/pre/terrain.py` but for the `kriging_gpu`
solve: the JAX package solves in float32 with `jnp.linalg.solve` and falls
back to numpy when that raises; here the solve is `torch.linalg.solve_ex`
on the device the caller names, and a device that fails raises.  `kriging`
(float64 numpy) and `idw` never touch a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class TerrainConfig:
    approach: str = "idw"            # idw | kriging | kriging_gpu
    grid_resolution: float = 50.0
    idw_sigma: float = 1.0
    idw_power: float = 2.0
    neighbors: int = 12
    kriging_range_factor: float = 3.0


def _knn(points_xy: np.ndarray, targets_xy: np.ndarray, k: int,
         chunk: int = 4096):
    """indices (Q, k) and distances (Q, k) of k nearest DEM points."""
    k = min(k, len(points_xy))
    idx = np.empty((len(targets_xy), k), np.int64)
    dist = np.empty((len(targets_xy), k), np.float64)
    p2 = (points_xy ** 2).sum(axis=1)
    for s in range(0, len(targets_xy), chunk):
        q = targets_xy[s:s + chunk]
        d2 = (q ** 2).sum(axis=1)[:, None] + p2[None] - 2.0 * q @ points_xy.T
        d2 = np.maximum(d2, 0.0)
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        rows = np.arange(len(q))[:, None]
        order = np.argsort(d2[rows, part], axis=1)
        sel = part[rows, order]
        idx[s:s + len(q)] = sel
        dist[s:s + len(q)] = np.sqrt(d2[rows, sel])
    return idx, dist


def idw_interpolate(points_xy: np.ndarray, values: np.ndarray,
                    targets_xy: np.ndarray, *, power: float = 2.0,
                    neighbors: int = 12) -> np.ndarray:
    idx, dist = _knn(points_xy, targets_xy, neighbors)
    w = 1.0 / np.maximum(dist, 1e-9) ** power
    exact = dist[:, 0] < 1e-9
    out = (w * values[idx]).sum(axis=1) / w.sum(axis=1)
    out[exact] = values[idx[exact, 0]]
    return out


def solve_systems(A: np.ndarray, b: np.ndarray,
                  device: torch.device | str) -> np.ndarray:
    """Solve the batched systems A x = b ((Q, n, n), (Q, n)) in float32 on
    `device`; a system whose factorisation fails (`info` != 0: a zero
    pivot, as duplicated DEM points give) yields NaN for its own row."""
    from ..run.modes import run_device

    dev = run_device(device)
    At = torch.as_tensor(A, dtype=torch.float32).to(dev)
    bt = torch.as_tensor(b, dtype=torch.float32).to(dev)
    sol, info = torch.linalg.solve_ex(At, bt.unsqueeze(-1))
    sol = sol[..., 0].masked_fill((info != 0).unsqueeze(-1), float("nan"))
    return sol.cpu().numpy()


def kriging_interpolate(points_xy: np.ndarray, values: np.ndarray,
                        targets_xy: np.ndarray, *, neighbors: int = 12,
                        range_factor: float = 3.0,
                        device: Optional[torch.device | str] = None
                        ) -> np.ndarray:
    """Ordinary kriging with exponential variogram gamma(h)=sill(1-exp(-3h/a)).

    `device=None` solves in float64 numpy (`kriging`); a device solves in
    float32 there (`kriging_gpu`, `solve_systems`)."""
    neighbors = min(max(neighbors, 3), 16, len(points_xy))
    idx, dist = _knn(points_xy, targets_xy, neighbors)
    nb_xy = points_xy[idx]                     # (Q, K, 2)
    nb_v = values[idx]                         # (Q, K)

    # variogram parameters from the local neighborhoods
    sill = max(float(np.var(values)), 1e-12)
    arange = max(float(np.median(dist[:, -1])) * range_factor, 1e-6)

    def gamma(h):
        return sill * (1.0 - np.exp(-3.0 * h / arange))

    Q, K = nb_v.shape
    # pairwise neighbor distances (Q, K, K)
    dmat = np.linalg.norm(nb_xy[:, :, None, :] - nb_xy[:, None, :, :], axis=3)
    A = np.ones((Q, K + 1, K + 1))
    A[:, :K, :K] = gamma(dmat)
    A[:, K, K] = 0.0
    b = np.ones((Q, K + 1))
    b[:, :K] = gamma(dist)

    if device is not None:
        sol = solve_systems(A, b, device)
    else:
        try:
            sol = np.linalg.solve(A, b[..., None])[..., 0]
        except np.linalg.LinAlgError:
            sol = np.full((Q, K + 1), np.nan)

    w = sol[:, :K]
    est = (w * nb_v).sum(axis=1)
    bad = ~np.isfinite(est)
    if bad.any():
        est[bad] = idw_interpolate(points_xy, values, targets_xy[bad],
                                   neighbors=neighbors)
    exact = dist[:, 0] < 1e-9
    est[exact] = nb_v[exact, 0]
    return est


def gaussian_smooth_grid(grid: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian smoothing on a 2-D grid (no scipy dependency)."""
    if sigma <= 0:
        return grid
    radius = max(1, int(3 * sigma))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = np.pad(grid, radius, mode="edge")
    tmp = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, pad)
    out = np.apply_along_axis(lambda c: np.convolve(c, k, mode="valid"), 0, tmp)
    return out


def interpolate_terrain_grid(
    dem_xy: np.ndarray, dem_z: np.ndarray,
    x_coords: np.ndarray, y_coords: np.ndarray,
    config: TerrainConfig, device: torch.device | str = "cuda",
) -> np.ndarray:
    """(len(y), len(x)) elevation grid using the configured approach;
    `kriging_gpu` solves its systems on `device`."""
    gx, gy = np.meshgrid(x_coords, y_coords)
    targets = np.stack([gx.ravel(), gy.ravel()], axis=1)
    if config.approach in ("kriging", "kriging_gpu"):
        z = kriging_interpolate(dem_xy, dem_z, targets,
                                neighbors=config.neighbors,
                                range_factor=config.kriging_range_factor,
                                device=(device if config.approach == "kriging_gpu"
                                        else None))
    else:
        z = idw_interpolate(dem_xy, dem_z, targets,
                            power=config.idw_power, neighbors=config.neighbors)
    grid = z.reshape(len(y_coords), len(x_coords))
    return gaussian_smooth_grid(grid, config.idw_sigma)


def terrain_config_from_deck(deck, cli_overrides: Optional[dict] = None) -> TerrainConfig:
    """Deck/CLI/default precedence for the terr_voxel_* keys
    (reference: terr_voxel_config.py)."""
    ov = cli_overrides or {}

    def pick(key, getter, default, valid=None):
        if key in ov and ov[key] is not None:
            v = ov[key]
        else:
            v = getter()
            if v is None:
                v = default
        if valid is not None and not valid(v):
            print(f"[terr_voxel] WARNING: invalid {key}={v!r}, using default {default!r}")
            v = default
        return v

    approach = str(pick("approach",
                        lambda: deck.get_text("terr_voxel_approach"),
                        "idw",
                        lambda v: str(v).lower() in ("idw", "kriging", "kriging_gpu"))).lower()
    return TerrainConfig(
        approach=approach,
        grid_resolution=float(pick("grid_resolution",
                                   lambda: deck.get_float("terr_voxel_grid_resolution"),
                                   50.0, lambda v: float(v) > 0)),
        idw_sigma=float(pick("idw_sigma",
                             lambda: deck.get_float("terr_voxel_idw_sigma"),
                             1.0, lambda v: float(v) >= 0)),
        idw_power=float(pick("idw_power",
                             lambda: deck.get_float("terr_voxel_idw_power"),
                             2.0, lambda v: float(v) > 0)),
        neighbors=int(pick("neighbors",
                           lambda: deck.get_int("terr_voxel_idw_neighbors"),
                           12, lambda v: int(v) > 0)),
    )
