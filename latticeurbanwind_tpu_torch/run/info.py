"""Console status: MLUPs / two-phase ETA.

Clean-room equivalent of the reference Info struct (info.hpp:7-38,
info.cpp:74-140): smoothed steps/s and MLUPs, and the two-phase ETA that
separately tracks normal-phase and averaging-phase step costs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class RunInfo:
    """Two-phase step-cost tracker and ETA."""

    total_steps: int
    avg_start: int = 0                      # first averaged step (0 = none)
    n_cells: int = 0
    smoothing: float = 0.2                  # EMA factor

    normal_s_per_step: float = 0.0
    avg_s_per_step: float = 0.0
    _last_t: Optional[int] = None
    _last_wall: Optional[float] = None

    def start(self, t: int) -> None:
        self._last_t = t
        self._last_wall = time.perf_counter()

    def update(self, t: int) -> None:
        now = time.perf_counter()
        if self._last_t is None or t <= self._last_t:
            self._last_t, self._last_wall = t, now
            return
        per_step = (now - self._last_wall) / (t - self._last_t)
        in_avg = self.avg_start and t > self.avg_start
        if in_avg:
            self.avg_s_per_step = (per_step if self.avg_s_per_step == 0 else
                                   (1 - self.smoothing) * self.avg_s_per_step
                                   + self.smoothing * per_step)
        else:
            self.normal_s_per_step = (per_step if self.normal_s_per_step == 0 else
                                      (1 - self.smoothing) * self.normal_s_per_step
                                      + self.smoothing * per_step)
        self._last_t, self._last_wall = t, now

    def steps_per_second(self, phase: str = "normal") -> float:
        sps = self.normal_s_per_step if phase == "normal" else self.avg_s_per_step
        return 1.0 / sps if sps > 0 else 0.0

    def mlups(self, phase: str = "normal") -> float:
        return self.n_cells * self.steps_per_second(phase) / 1e6

    def eta_seconds(self, t: int) -> float:
        """Remaining wall time with separate phase costs (two-phase model)."""
        if self.avg_start and t < self.avg_start:
            normal_left = self.avg_start - t
            avg_left = self.total_steps - self.avg_start
        elif self.avg_start:
            normal_left = 0
            avg_left = self.total_steps - t
        else:
            normal_left = self.total_steps - t
            avg_left = 0
        n_cost = self.normal_s_per_step
        a_cost = self.avg_s_per_step or n_cost
        return max(0.0, normal_left * n_cost + avg_left * a_cost)

    def timing_plan(self, impl: str) -> str:
        line = (f"| LBM TIMING PLAN | impl={impl} "
                f"normal {self.steps_per_second():.1f} steps/s "
                f"({self.mlups():.0f} MLUPs, the calibration batch)")
        if self.avg_s_per_step > 0:
            line += (f", averaging {self.steps_per_second('avg'):.1f} steps/s")
        return line
