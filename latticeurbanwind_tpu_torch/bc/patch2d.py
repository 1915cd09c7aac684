"""Patch-driven 2-D structured surface fields (the patch-CSV BC path).

Clean-room equivalent of the reference PatchSurfaceField2D
(reference: setup.cpp:1862-2096): per-patch samples are grouped into
a-columns by tolerance, each column holds (b, value) pairs; evaluation is
linear interpolation in b within the two bracketing columns, then linear
blend across a.  `below_sample_support` detects side-face queries below the
terrain-supported region.

Patch surface coordinates (setup.cpp:1837-1859):
  bottom/top: (a, b) = (x, y);  south/north: (x, z);  west/east: (y, z).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .samples import (
    PATCH_BOTTOM, PATCH_EAST, PATCH_NORTH, PATCH_SOUTH, PATCH_TOP, PATCH_WEST,
    SampleSet,
)


def patch_surface_coords(patch: int, p: np.ndarray):
    """(N,3) positions -> (a, b) arrays for the given patch id."""
    if patch in (PATCH_BOTTOM, PATCH_TOP):
        return p[..., 0], p[..., 1]
    if patch in (PATCH_SOUTH, PATCH_NORTH):
        return p[..., 0], p[..., 2]
    if patch in (PATCH_WEST, PATCH_EAST):
        return p[..., 1], p[..., 2]
    raise ValueError(f"invalid patch {patch}")


def boundary_cell_patch(x, y, z, nx, ny, nz):
    """Vectorized boundary-cell -> patch id (top priority, then W/E/S/N; -1 interior)."""
    fid = np.full(np.broadcast(x, y, z).shape, -1, dtype=np.int8)
    fid = np.where(y == ny - 1, PATCH_NORTH, fid)
    fid = np.where(y == 0, PATCH_SOUTH, fid)
    fid = np.where(x == nx - 1, PATCH_EAST, fid)
    fid = np.where(x == 0, PATCH_WEST, fid)
    fid = np.where(z == nz - 1, PATCH_TOP, fid)
    return fid


def downstream_patch(downstream_bc: str) -> int:
    return {"+y": PATCH_NORTH, "-y": PATCH_SOUTH, "+x": PATCH_EAST, "-x": PATCH_WEST}.get(
        downstream_bc, -1)


class PatchField2D:
    """Column-structured 2-D field over one patch surface."""

    def __init__(self, a: np.ndarray, b: np.ndarray, values: np.ndarray,
                 default=0.0):
        """a, b: (N,) surface coords; values: (N, C)."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        if values.shape[0] != len(a):
            values = values.T
        self.ncomp = values.shape[1]
        self.default = np.broadcast_to(np.asarray(default, dtype=np.float64),
                                       (self.ncomp,)).copy()
        self.raw_count = len(a)
        self.a_coords = np.empty(0)
        self.b_cols: list = []
        self.v_cols: list = []
        if self.raw_count == 0:
            return

        self.default = values.mean(axis=0)
        tol_a = max(1e-6, 1e-6 * max(1.0, float(a.max() - a.min())))
        tol_b = max(1e-6, 1e-6 * max(1.0, float(b.max() - b.min())))

        order = np.lexsort((b, a))
        a_s, b_s, v_s = a[order], b[order], values[order]
        # group into a-columns by running-mean tolerance
        cols = []
        start = 0
        a_sum, a_cnt = a_s[0], 1
        for i in range(1, len(a_s)):
            if abs(a_s[i] - a_sum / a_cnt) <= tol_a:
                a_sum += a_s[i]
                a_cnt += 1
            else:
                cols.append((start, i, a_sum / a_cnt))
                start, a_sum, a_cnt = i, a_s[i], 1
        cols.append((start, len(a_s), a_sum / a_cnt))

        for s0, s1, a_rep in cols:
            bb = b_s[s0:s1]
            vv = v_s[s0:s1]
            # merge near-duplicate b entries (running average)
            out_b, out_v, counts = [], [], []
            for j in range(len(bb)):
                if out_b and abs(bb[j] - out_b[-1]) <= tol_b:
                    counts[-1] += 1
                    out_b[-1] = 0.5 * (out_b[-1] + bb[j])
                    out_v[-1] = out_v[-1] + (vv[j] - out_v[-1]) / counts[-1]
                else:
                    out_b.append(float(bb[j]))
                    out_v.append(vv[j].copy())
                    counts.append(1)
            self.a_coords = np.append(self.a_coords, a_rep)
            self.b_cols.append(np.asarray(out_b))
            self.v_cols.append(np.asarray(out_v))

    @classmethod
    def from_samples(cls, samples: SampleSet, patch: int,
                     value_fn: Callable[[SampleSet, np.ndarray], np.ndarray],
                     default=0.0) -> "PatchField2D":
        mask = (samples.patch == patch) if samples.patch is not None else np.zeros(
            len(samples.p), dtype=bool)
        a, b = patch_surface_coords(patch, samples.p[mask])
        return cls(a, b, value_fn(samples, mask), default=default)

    @property
    def has_samples(self) -> bool:
        return self.raw_count > 0

    def _eval_column(self, ci: int, b: np.ndarray) -> np.ndarray:
        bv, vv = self.b_cols[ci], self.v_cols[ci]
        if len(bv) == 1:
            return np.broadcast_to(vv[0], (len(b), self.ncomp)).copy()
        i1 = np.clip(np.searchsorted(bv, b, side="right"), 1, len(bv) - 1)
        i0 = i1 - 1
        t = np.where(np.abs(bv[i1] - bv[i0]) > 1e-12,
                     (b - bv[i0]) / np.where(np.abs(bv[i1] - bv[i0]) > 1e-12,
                                             bv[i1] - bv[i0], 1.0), 0.0)
        t = np.clip(t, 0.0, 1.0)
        return vv[i0] + t[:, None] * (vv[i1] - vv[i0])

    def eval(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Vectorized: (Q,) a,b -> (Q, C) values."""
        a = np.atleast_1d(np.asarray(a, dtype=np.float64))
        b = np.atleast_1d(np.asarray(b, dtype=np.float64))
        Q = len(a)
        if not self.has_samples or len(self.a_coords) == 0:
            return np.broadcast_to(self.default, (Q, self.ncomp)).copy()
        if len(self.a_coords) == 1:
            return self._eval_column(0, b)
        i1 = np.clip(np.searchsorted(self.a_coords, a, side="right"),
                     1, len(self.a_coords) - 1)
        i0 = i1 - 1
        lo = a <= self.a_coords[0]
        hi = a >= self.a_coords[-1]
        # evaluate the two bracketing columns per query, grouped by column id
        v0 = np.empty((Q, self.ncomp))
        v1 = np.empty((Q, self.ncomp))
        for ci in np.unique(i0):
            m = i0 == ci
            v0[m] = self._eval_column(int(ci), b[m])
        for ci in np.unique(i1):
            m = i1 == ci
            v1[m] = self._eval_column(int(ci), b[m])
        a0 = self.a_coords[i0]
        a1 = self.a_coords[i1]
        t = np.where(np.abs(a1 - a0) > 1e-12, (a - a0) / np.where(
            np.abs(a1 - a0) > 1e-12, a1 - a0, 1.0), 0.0)
        t = np.where(lo, 0.0, np.where(hi, 1.0, t))
        out = v0 + t[:, None] * (v1 - v0)
        # clamped ends use the end column only
        for m, ci in ((lo, 0), (hi, len(self.a_coords) - 1)):
            if m.any():
                out[m] = self._eval_column(ci, b[m])
        return out

    def below_sample_support(self, a: np.ndarray, b: np.ndarray,
                             eps: float = 1e-4) -> np.ndarray:
        """True where b lies below the interpolated minimum-b envelope."""
        a = np.atleast_1d(np.asarray(a, dtype=np.float64))
        b = np.atleast_1d(np.asarray(b, dtype=np.float64))
        if not self.has_samples or len(self.a_coords) == 0:
            return np.zeros(len(a), dtype=bool)
        bmins = np.asarray([bc[0] for bc in self.b_cols])
        if len(self.a_coords) == 1:
            return b < bmins[0] - eps
        i1 = np.clip(np.searchsorted(self.a_coords, a, side="right"),
                     1, len(self.a_coords) - 1)
        i0 = i1 - 1
        a0, a1 = self.a_coords[i0], self.a_coords[i1]
        t = np.where(np.abs(a1 - a0) > 1e-12, (a - a0) / np.where(
            np.abs(a1 - a0) > 1e-12, a1 - a0, 1.0), 0.0)
        t = np.clip(t, 0.0, 1.0)
        t = np.where(a <= self.a_coords[0], 0.0, np.where(a >= self.a_coords[-1], 1.0, t))
        bmin = bmins[i0] + t * (bmins[i1] - bmins[i0])
        return b < bmin - eps
