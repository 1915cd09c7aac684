"""Global mass-flux correction over the equilibrium-boundary shell.

Clean-room equivalent of the reference (fluxcorrection.cpp:28-194): every
non-solid outer-shell cell above the ground plane is marked TYPE_E, the net
normal flux through the shell is computed, and a uniform delta is added to
each cell's face-normal velocity component so the net is ~0.  Face pick
priority for edge/corner cells: top, x-min, x-max, y-min, y-max.

Vectorized numpy; returns a small report dict matching the reference's
console numbers (S_in/S_out/net_before/net_after/avg_dU per face).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .state import TYPE_E, TYPE_S

_FACES = ("ztop", "xmin", "xmax", "ymin", "ymax")


def _face_ids(shape) -> np.ndarray:
    """Face id per cell: 0..4 per _FACES, -1 interior/ground, priority order
    matching the reference's pick_face."""
    Z, Y, X = shape
    z, y, x = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X), indexing="ij")
    fid = np.full(shape, -1, dtype=np.int8)
    fid[y == Y - 1] = 4
    fid[y == 0] = 3
    fid[x == X - 1] = 2
    fid[x == 0] = 1
    fid[z == Z - 1] = 0
    fid[z == 0] = -1
    return fid


def apply_flux_correction(
    flags: np.ndarray,
    u: np.ndarray,
    *,
    downstream_bc: str = "",
    downstream_eval: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Returns (flags, u, report).  `downstream_eval(mask) -> (3, Z, Y, X)`
    optionally refills the downstream face velocities before balancing."""
    flags = np.array(flags, copy=True)
    u = np.array(u, copy=True)
    shape = flags.shape
    fid = _face_ids(shape)
    solid = (flags & TYPE_S) != 0
    on_shell = (fid >= 0) & ~solid
    flags[on_shell] |= TYPE_E

    if downstream_eval is not None and downstream_bc:
        Z, Y, X = shape
        ds = np.zeros(shape, dtype=bool)
        if downstream_bc == "+y":
            ds[:, -1, :] = True
        elif downstream_bc == "-y":
            ds[:, 0, :] = True
        elif downstream_bc == "+x":
            ds[:, :, -1] = True
        elif downstream_bc == "-x":
            ds[:, :, 0] = True
        sel = ds & on_shell
        filled = downstream_eval(sel)
        for c in range(3):
            u[c][sel] = filled[c][sel]

    # outward normal component and its sign per face
    comp = np.select([fid == 0, (fid == 1) | (fid == 2)], [u[2], u[0]], default=u[1])
    sign = np.select([fid == 0, fid == 2, fid == 4], [1.0, 1.0, 1.0],
                     default=-1.0)
    vn = np.where(on_shell, sign * comp, 0.0)
    net_before = float(vn.sum())
    s_in = float(-vn[vn < 0].sum())
    s_out = float(vn[vn > 0].sum())
    count = int(on_shell.sum())
    delta = (-net_before / count) if count else 0.0

    per_face = {}
    for f, name in enumerate(_FACES):
        sel = on_shell & (fid == f)
        axis = 2 if f == 0 else (0 if f in (1, 2) else 1)
        sgn = 1.0 if f in (0, 2, 4) else -1.0
        u[axis][sel] += sgn * delta
        per_face[f"avg_dU_{name}"] = abs(delta) if sel.any() else 0.0

    comp = np.select([fid == 0, (fid == 1) | (fid == 2)], [u[2], u[0]], default=u[1])
    vn_after = np.where(on_shell, sign * comp, 0.0)
    report = {
        "S_in": s_in,
        "S_out": s_out,
        "net_before": net_before,
        "net_after": float(vn_after.sum()),
        "avg_dU": abs(delta),
        "corrected": count,
        **per_face,
    }
    return flags, u, report
