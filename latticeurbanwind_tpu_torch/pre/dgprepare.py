"""dgprepare — dataset-gen/profile geometry prep: raw building STL -> case STL.

Counterpart of `latticeurbanwind_tpu/pre/dgprepare.py` (host numpy, no
device work): load building_db/rawbuildings.stl, put a rectangular base
block under it (x/y extents expanded by x_exp_rat/y_exp_rat, thickness
base_height), merge by concatenation, shift to the solver frame with the
base starting at z=0, write proj_temp/<case>_DG.stl (.luwdg) or _PF.stl
(.luwpf), and write back si_x_cfd / si_y_cfd / si_z_cfd = [0, z_limit +
base_height].  The STL and the deck come out byte for byte as the JAX
package writes them.

    python -m latticeurbanwind_tpu_torch.cli.dispatch dgprepare conf.luwpf
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..deck import deck_mode_from_path, load_deck
from ..geometry import Mesh, read_stl, write_stl


def _base_block(bounds_min, bounds_max, base_height, x_exp, y_exp) -> np.ndarray:
    dx = (bounds_max[0] - bounds_min[0]) * x_exp
    dy = (bounds_max[1] - bounds_min[1]) * y_exp
    cx = 0.5 * (bounds_min[0] + bounds_max[0])
    cy = 0.5 * (bounds_min[1] + bounds_max[1])
    z1 = bounds_min[2]
    z0 = z1 - base_height
    lo = (cx - dx / 2, cy - dy / 2, z0)
    hi = (cx + dx / 2, cy + dy / 2, z1)
    # inline box construction (12 triangles)
    c = np.array([
        [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]],
        [lo[0], hi[1], lo[2]], [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]],
    ], dtype=np.float32)
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6),
             (1, 2, 6, 5), (3, 0, 4, 7)]
    tris = []
    for a, b, cc, d in quads:
        tris += [[c[a], c[b], c[cc]], [c[a], c[cc], c[d]]]
    return np.asarray(tris, dtype=np.float32)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: dgprepare <conf.luwdg|conf.luwpf>")
        return 2
    deck_path = Path(argv[0]).expanduser().resolve()
    mode = deck_mode_from_path(deck_path)
    if mode == "luw":
        print("dgprepare: only .luwdg/.luwpf decks are supported")
        return 2
    deck = load_deck(deck_path)
    home = deck_path.parent
    casename = deck.get_text("casename") or "case"
    base_height = deck.get_float("base_height")
    x_exp = deck.get_float("x_exp_rat")
    y_exp = deck.get_float("y_exp_rat")
    z_limit = deck.get_float("z_limit")
    for name, val in (("base_height", base_height), ("x_exp_rat", x_exp),
                      ("y_exp_rat", y_exp), ("z_limit", z_limit)):
        if val is None or val <= 0:
            print(f"dgprepare: FATAL: {name} missing or non-positive")
            return 1

    raw = home / "building_db" / "rawbuildings.stl"
    if not raw.exists():
        candidates = sorted((home / "building_db").glob("*.stl"))
        if not candidates:
            print(f"dgprepare: FATAL: no STL under {home / 'building_db'}")
            return 1
        raw = candidates[0]
    mesh = read_stl(raw)
    print(f"dgprepare: loaded {raw.name}: {len(mesh.tris)} triangles, "
          f"bounds {mesh.pmin.round(2)}..{mesh.pmax.round(2)}")

    base = _base_block(mesh.pmin, mesh.pmax, base_height, x_exp, y_exp)
    merged = Mesh(tris=np.concatenate([mesh.tris, base]))
    # solver frame: (xmin, ymin) -> 0, base bottom -> z=0
    shifted = merged.translated((-merged.pmin[0], -merged.pmin[1], -merged.pmin[2]))

    suffix = "_DG" if mode == "luwdg" else "_PF"
    out = home / "proj_temp" / f"{casename}{suffix}.stl"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_stl(out, shifted)
    print(f"dgprepare: wrote {out.name}: bounds {shifted.pmin.round(2)}.."
          f"{shifted.pmax.round(2)}")

    deck.set_pair("si_x_cfd", (0.0, float(shifted.pmax[0])))
    deck.set_pair("si_y_cfd", (0.0, float(shifted.pmax[1])))
    deck.set_pair("si_z_cfd", (0.0, float(z_limit) + float(base_height)))
    deck.save()
    print("dgprepare: deck si_x/y/z_cfd updated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
