"""SurfData CSV ingestion: the NWP boundary-sample contract.

Format (reference: setup.cpp:2291-2440 read_samples): header row with named
columns X,Y,Z,u,v,w[,T][,patch] (case-insensitive) or legacy positional 6-8
column rows; SI units; patch ids 0=bottom 1=top 2=south 3=north 4=west 5=east.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

PATCH_BOTTOM, PATCH_TOP, PATCH_SOUTH, PATCH_NORTH, PATCH_WEST, PATCH_EAST = range(6)
PATCH_NAMES = ("bottom", "top", "south", "north", "west", "east")


@dataclass
class SampleSet:
    p: np.ndarray                    # (N, 3) SI positions
    u: np.ndarray                    # (N, 3) SI velocities
    T: Optional[np.ndarray] = None   # (N,) SI Kelvin
    patch: Optional[np.ndarray] = None  # (N,) int

    @property
    def has_temperature(self) -> bool:
        return self.T is not None

    @property
    def has_patch(self) -> bool:
        return self.patch is not None

    @property
    def max_speed(self) -> float:
        return float(np.sqrt((self.u ** 2).sum(axis=1)).max()) if len(self.u) else 0.0

    def temperature_range(self):
        if self.T is None or not len(self.T):
            return None
        return float(self.T.min()), float(self.T.max())


def read_surfdata_csv(path: Path | str) -> SampleSet:
    lines = Path(path).read_text().splitlines()
    if not lines:
        raise ValueError(f"empty CSV {path}")
    header = [c.strip().lower() for c in lines[0].split(",")]
    idx = {name: header.index(name) for name in ("x", "y", "z", "u", "v", "w")
           if name in header}
    named = len(idx) == 6
    idx_t = header.index("t") if "t" in header else -1
    idx_patch = header.index("patch") if "patch" in header else -1

    if named:
        # native fast path: one C pass over the body (production SurfData
        # files reach 10^5-10^6 rows; the reference's std::stod loop scale)
        from ..utils.native import parse_csv_native

        table = parse_csv_native(Path(path).read_bytes(),
                                 max_cols=max(len(header), 8))
        if table is not None:
            need = [idx[k] for k in ("x", "y", "z", "u", "v", "w")]
            ok = np.isfinite(table[:, need]).all(axis=1)
            table = table[ok]
            if len(table):
                p = table[:, need[0:3]]
                u = table[:, need[3:6]]
                T = table[:, idx_t] if 0 <= idx_t < table.shape[1] else None
                patch = None
                if 0 <= idx_patch < table.shape[1]:
                    pa = table[:, idx_patch]
                    # rint before the cast so non-integer patch values parse
                    # identically to the Python fallback's round()
                    patch = np.rint(
                        np.where(np.isfinite(pa), pa, -999)).astype(np.int32)
                return SampleSet(
                    p=p, u=u,
                    T=(np.where(np.isfinite(T), T, 293.15)
                       if T is not None else None),
                    patch=patch,
                )

    rows = []
    body = lines[1:] if named or idx_t >= 0 or idx_patch >= 0 or not _numeric_row(lines[0]) else lines
    for line in body:
        cols = [c.strip() for c in line.split(",")]
        if not any(cols):
            continue
        try:
            if named:
                need = max(idx.values())
                if len(cols) <= need:
                    continue
                vals = [float(cols[idx[k]]) for k in ("x", "y", "z", "u", "v", "w")]
                # blank optional cells don't invalidate the velocity sample
                t = (float(cols[idx_t])
                     if 0 <= idx_t < len(cols) and cols[idx_t] else np.nan)
                pt = (round(float(cols[idx_patch]))
                      if 0 <= idx_patch < len(cols) and cols[idx_patch] else -999)
            else:
                nums = [float(c) for c in cols if c]
                if not (6 <= len(nums) <= 8):
                    continue
                vals = nums[:6]
                t = nums[6] if len(nums) >= 7 else np.nan
                pt = int(round(nums[7])) if len(nums) == 8 else -999
        except ValueError:
            continue
        rows.append((*vals, t, pt))

    if not rows:
        raise ValueError(f"no samples parsed from {path}")
    arr = np.asarray(rows, dtype=np.float64)
    p = arr[:, 0:3]
    u = arr[:, 3:6]
    T = arr[:, 6]
    patch = arr[:, 7].astype(np.int32)
    has_T = named and idx_t >= 0 or (not named and np.isfinite(T).any())
    has_patch = (idx_patch >= 0) or (not named and (patch != -999).any())
    return SampleSet(
        p=p, u=u,
        T=np.where(np.isfinite(T), T, 293.15) if has_T else None,
        patch=patch if has_patch else None,
    )


def _numeric_row(line: str) -> bool:
    try:
        [float(c) for c in line.split(",") if c.strip()]
        return True
    except ValueError:
        return False
