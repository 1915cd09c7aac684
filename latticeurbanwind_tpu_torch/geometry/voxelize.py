"""Triangle-mesh voxelization to lattice solid flags.

The reference voxelizes on GPU by per-cell ray casting with triangle parity
counting (reference: kernel.cpp:2381-2478, host driver lbm.cpp:494-606).  The
TPU-native equivalent is column parity: for every (x, y) lattice column, cast
a vertical ray, collect triangle crossings of the column center, sort the
crossing heights, and mark cells whose center lies inside an odd-parity
interval.  This is exact for watertight meshes (the only kind the pipeline
produces: terrain + extruded prisms) and runs as a single vectorized
numpy/jnp program over all columns.

Coordinates: the mesh lives in lattice units where cell (i) spans
[i, i+1) and cell centers sit at i + 0.5 along each axis.
"""

from __future__ import annotations

import numpy as np

from .stl import Mesh


def _column_crossings(tris: np.ndarray, px: np.ndarray, py: np.ndarray,
                      batch: int = 2_000_000):
    """For each column center (px, py), intersect the vertical ray with all
    triangles; returns per-column sorted crossing z lists (ragged via masks).

    Vectorized over columns x triangles in batches to bound memory.
    """
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    ncol = px.size
    ntri = len(tris)
    # 2-D edge-function point-in-triangle test in the (x, y) projection.
    x0, y0 = v0[:, 0], v0[:, 1]
    x1, y1 = v1[:, 0], v1[:, 1]
    x2, y2 = v2[:, 0], v2[:, 1]
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    # skip degenerate (vertical) triangles in projection
    good = np.abs(denom) > 1e-12
    inv_denom = np.where(good, 1.0 / np.where(good, denom, 1.0), 0.0)

    crossings = [[] for _ in range(ncol)]
    cols_per_batch = max(1, batch // max(ntri, 1))
    for start in range(0, ncol, cols_per_batch):
        sl = slice(start, min(start + cols_per_batch, ncol))
        pxs = px[sl][:, None]
        pys = py[sl][:, None]
        l0 = ((y1 - y2) * (pxs - x2) + (x2 - x1) * (pys - y2)) * inv_denom
        l1 = ((y2 - y0) * (pxs - x2) + (x0 - x2) * (pys - y2)) * inv_denom
        l2 = 1.0 - l0 - l1
        # half-open edge rule keeps shared-edge crossings counted once
        inside = good & (l0 >= 0) & (l1 >= 0) & (l2 > 0) & (l0 <= 1) & (l1 <= 1)
        zhit = l0 * v0[:, 2] + l1 * v1[:, 2] + l2 * v2[:, 2]
        for ci, row in enumerate(inside):
            idx = np.nonzero(row)[0]
            if idx.size:
                crossings[start + ci] = sorted(zhit[ci, idx].tolist())
    return crossings


def voxelize_mesh_columns(mesh: Mesh, shape, jitter: float = 1e-4,
                          use_native: bool = True) -> np.ndarray:
    """Solid mask (Z, Y, X) bool from a watertight mesh in lattice units.

    `jitter` nudges ray origins off exact vertex/edge alignments (the same
    robustness trick as the reference's ray-direction jitter).  Uses the
    native C++ voxelizer when available (utils/native.py); the numpy path
    below is the reference implementation and fallback.
    """
    if use_native and len(mesh.tris):
        from ..utils.native import voxelize_columns_native

        native = voxelize_columns_native(mesh.tris, shape, jitter)
        if native is not None:
            return native
    Z, Y, X = shape
    ys, xs = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    px = (xs.ravel() + 0.5 + jitter).astype(np.float64)
    py = (ys.ravel() + 0.5 + jitter * 1.618).astype(np.float64)
    crossings = _column_crossings(np.asarray(mesh.tris, dtype=np.float64), px, py)

    solid = np.zeros((Z, Y, X), dtype=bool)
    zc = np.arange(Z) + 0.5
    flat = solid.reshape(Z, Y * X)
    for col, zs in enumerate(crossings):
        if not zs:
            continue
        if len(zs) % 2 == 1:
            # non-watertight column (mesh clipped at the domain floor):
            # treat the solid as extending down from the first crossing
            zs = [-np.inf] + zs
        inside = np.zeros(Z, dtype=bool)
        # parity fill between successive crossings
        for lo, hi in zip(zs[0::2], zs[1::2]):
            inside |= (zc >= lo) & (zc < hi)
        flat[:, col] = inside
    return solid


def voxelize_solid_flags(mesh: Mesh, shape, flag_value: int = 0x01) -> np.ndarray:
    """uint8 flag grid with `flag_value` set on solid cells."""
    solid = voxelize_mesh_columns(mesh, shape)
    return np.where(solid, np.uint8(flag_value), np.uint8(0))
