"""buildingscale — urban-morphology statistics from the voxelized case.

Counterpart of `latticeurbanwind_tpu/post/buildingscale.py` (host numpy):
plan-area density lambda_p, frontal-area densities lambda_f from +x and
+y, mean/max building height and the built column count, from the case
STL voxelized on a quick grid of at most 256 cells across.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..deck import load_deck
from ..geometry import Mesh, read_stl, voxelize_mesh_columns


def morphology_stats(solid: np.ndarray, cell_m: float, ground_k: int = 1) -> dict:
    """Stats over the building region above `ground_k` lattice planes."""
    bld = solid[ground_k:]
    Z, Y, X = bld.shape
    col_any = bld.any(axis=0)
    heights = bld.sum(axis=0) * cell_m            # per-column built height
    lambda_p = float(col_any.mean())
    # frontal areas: projected solid faces seen from +x and +y
    face_x = (bld & ~np.roll(bld, 1, axis=2))
    face_y = (bld & ~np.roll(bld, 1, axis=1))
    plan_area = Y * X * cell_m * cell_m
    lambda_f_x = float(face_x.sum() * cell_m * cell_m / plan_area)
    lambda_f_y = float(face_y.sum() * cell_m * cell_m / plan_area)
    built = heights[col_any]
    return {
        "lambda_p": lambda_p,
        "lambda_f_x": lambda_f_x,
        "lambda_f_y": lambda_f_y,
        "mean_height_m": float(built.mean()) if built.size else 0.0,
        "max_height_m": float(built.max()) if built.size else 0.0,
        "built_columns": int(col_any.sum()),
    }


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: buildingscale <deck file>")
        return 2
    deck_path = Path(argv[0]).expanduser().resolve()
    deck = load_deck(deck_path)
    casename = deck.get_text("casename") or "case"
    home = deck_path.parent
    stl = None
    for suffix in ("_DG", "_PF", ""):
        cand = home / "proj_temp" / f"{casename}{suffix}.stl"
        if cand.exists():
            stl = cand
            break
    if stl is None:
        print("buildingscale: no case STL found (run luwvox/dgprepare first)")
        return 1
    mesh = read_stl(stl)
    cell = max(float(mesh.size[:2].max()) / 256.0, 1.0)
    shape = (max(4, int(mesh.size[2] / cell) + 2),
             max(4, int(mesh.size[1] / cell)), max(4, int(mesh.size[0] / cell)))
    tris = (np.asarray(mesh.tris, np.float64) - mesh.pmin) / cell
    solid = voxelize_mesh_columns(Mesh(tris=tris.astype(np.float32)), shape)
    base_h = deck.get_float("base_height", 50.0) or 50.0
    ground_k = int(round(base_h / cell))
    stats = morphology_stats(solid, cell, ground_k)
    print(f"buildingscale: {casename} (cell {cell:.1f} m)")
    for k, v in stats.items():
        print(f"  {k:>15s} = {v:.4f}" if isinstance(v, float) else f"  {k:>15s} = {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
