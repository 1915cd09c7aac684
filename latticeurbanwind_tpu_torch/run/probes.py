"""Probe columns: per-step velocity sampling + CSV output.

File contract matches the reference (setup.cpp:4718-4760): one CSV per probe
in RESULTS/, header `height (m),<t0>,<t1>,...`, one row per height, each cell
`u:v:w` in SI m/s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np


def _trim(v: float, places: int = 6) -> str:
    s = f"{v:.{places}f}".rstrip("0").rstrip(".")
    return s if s else "0"


@dataclass
class GridProbe:
    """A vertical probe column at lattice indices (x, y)."""

    file_stem: str
    x: int
    y: int
    z_indices: List[int]
    heights_si: List[float]
    times_si: List[float] = field(default_factory=list)
    series: List[np.ndarray] = field(default_factory=list)  # (levels, 3) SI per time

    def sample_column(self, u_column: np.ndarray, time_si: float, u_factor: float) -> None:
        """u_column: (3, Z) lattice-unit velocity at this probe's (x, y)."""
        zs = np.asarray(self.z_indices)
        vals = np.asarray(u_column)[:, zs].T * u_factor        # (levels, 3)
        self.times_si.append(time_si)
        self.series.append(vals)

    def write_csv(self, results_dir: Path | str) -> Path:
        out = Path(results_dir) / f"{self.file_stem}.csv"
        out.parent.mkdir(parents=True, exist_ok=True)
        lines = ["height (m)" + "".join(f",{_trim(t)}" for t in self.times_si)]
        for level, h in enumerate(self.heights_si):
            cells = "".join(
                ",{}:{}:{}".format(_trim(s[level, 0]), _trim(s[level, 1]), _trim(s[level, 2]))
                for s in self.series
            )
            lines.append(_trim(h) + cells)
        out.write_text("\n".join(lines) + "\n")
        return out
