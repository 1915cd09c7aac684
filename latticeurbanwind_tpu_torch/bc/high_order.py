"""High-order boundary interpolation: per-plane KNN + quadratic weighted LSQ.

Clean-room equivalent of the reference KNNInterpolatorHD
(reference: interpolation_hd.cpp:184-440):

  1. assign each query to the nearest bounding plane of the sample cloud
     (x-min, x-max, y-min, y-max, z-max);
  2. keep only samples lying on that plane (tol = 1e-5*extent + 1e-6);
  3. 2-D in-plane offsets (s1, s2) relative to the query; exact hit returns
     the sample value;
  4. K=64 nearest in-plane samples; sigma^2 = max kept r^2 / 4; Gaussian
     weights w = exp(-r^2 / (2 sigma^2));
  5. 6-term quadratic weighted LSQ [1, s1, s2, s1^2, s1 s2, s2^2]; the value
     is the constant coefficient;
  6. fallbacks: fewer than 6 neighbors or singular system -> Gaussian-weighted
     mean; no in-plane samples -> zero.

Vectorized: per plane, distances are one (Q_plane, S_plane) product, top-K a
partition, and the 6x6 solves are batched, in numpy on the host (set-up
work, once per case), as in the JAX package, whose module this is.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

K_NEIGHBORS = 64


class KNNInterpolatorHD:
    def __init__(self, points: np.ndarray, values: np.ndarray):
        """points (S,3), values (S,C)."""
        self.P = np.asarray(points, dtype=np.float64)
        V = np.asarray(values, dtype=np.float64)
        self.V = V[:, None] if V.ndim == 1 else V
        self.ncomp = self.V.shape[1]
        if len(self.P) == 0:
            self.planes = []
            return
        mins = self.P.min(axis=0)
        maxs = self.P.max(axis=0)
        extent = float((maxs - mins).max())
        tol = 1e-5 * extent + 1e-6
        self.bounds = (mins, maxs)
        # plane ids: 0 x-min, 1 x-max, 2 y-min, 3 y-max, 4 z-max
        defs = [
            (0, np.abs(self.P[:, 0] - mins[0]) <= tol, (1, 2)),
            (1, np.abs(self.P[:, 0] - maxs[0]) <= tol, (1, 2)),
            (2, np.abs(self.P[:, 1] - mins[1]) <= tol, (0, 2)),
            (3, np.abs(self.P[:, 1] - maxs[1]) <= tol, (0, 2)),
            (4, np.abs(self.P[:, 2] - maxs[2]) <= tol, (0, 1)),
        ]
        self.planes = [
            {
                "axes": axes,
                "pts": self.P[mask][:, list(axes)],
                "vals": self.V[mask],
            }
            for pid, mask, axes in defs
        ]

    def _assign_plane(self, q: np.ndarray) -> np.ndarray:
        mins, maxs = self.bounds
        d = np.stack([
            np.abs(q[:, 0] - mins[0]),
            np.abs(q[:, 0] - maxs[0]),
            np.abs(q[:, 1] - mins[1]),
            np.abs(q[:, 1] - maxs[1]),
            np.abs(q[:, 2] - maxs[2]),
        ])
        return d.argmin(axis=0)

    def eval(self, queries: np.ndarray, *, chunk: int = 16384) -> np.ndarray:
        q = np.atleast_2d(np.asarray(queries, dtype=np.float64))
        out = np.zeros((len(q), self.ncomp))
        if not self.planes:
            return out
        plane_of = self._assign_plane(q)
        for pid in range(5):
            sel = np.nonzero(plane_of == pid)[0]
            if not len(sel):
                continue
            plane = self.planes[pid]
            if len(plane["pts"]) == 0:
                continue
            a0, a1 = plane["axes"]
            q2d = q[sel][:, [a0, a1]]
            for start in range(0, len(sel), chunk):
                block = slice(start, start + chunk)
                out[sel[block]] = self._eval_plane(
                    plane["pts"], plane["vals"], q2d[block])
        return out

    @staticmethod
    def _eval_plane(pts: np.ndarray, vals: np.ndarray, q2d: np.ndarray) -> np.ndarray:
        S = len(pts)
        K = min(K_NEIGHBORS, S)
        # in-plane offsets s = p - q per (query, sample)
        diff = pts[None, :, :] - q2d[:, None, :]          # (Q, S, 2)
        r2 = (diff ** 2).sum(axis=2)                      # (Q, S)
        if S > K:
            idx = np.argpartition(r2, K - 1, axis=1)[:, :K]
        else:
            idx = np.broadcast_to(np.arange(S), (len(q2d), S)).copy()
        rows = np.arange(len(q2d))[:, None]
        r2k = r2[rows, idx]                               # (Q, K)
        sk = diff[rows, idx]                              # (Q, K, 2)
        vk = vals[idx]                                    # (Q, K, C)

        exact = r2k.min(axis=1) <= 1e-16
        sigma2 = 0.25 * np.maximum(r2k.max(axis=1), 1e-12)
        w = np.exp(-r2k / (2.0 * sigma2[:, None]))        # (Q, K)

        # quadratic basis phi = [1, s1, s2, s1^2, s1 s2, s2^2]
        s1, s2 = sk[..., 0], sk[..., 1]
        phi = np.stack([np.ones_like(s1), s1, s2, s1 * s1, s1 * s2, s2 * s2],
                       axis=2)                            # (Q, K, 6)
        wphi = w[..., None] * phi
        A = np.einsum("qki,qkj->qij", wphi, phi)          # (Q, 6, 6)
        B = np.einsum("qki,qkc->qic", wphi, vk)           # (Q, 6, C)

        out = np.empty((len(q2d), vals.shape[1]))
        ok = K >= 6
        solved = np.zeros(len(q2d), dtype=bool)
        if ok:
            # batched solve with singularity detection
            det_ok = np.abs(np.linalg.det(A)) > 1e-18
            if det_ok.any():
                sol = np.linalg.solve(A[det_ok], B[det_ok])   # (n, 6, C)
                out[det_ok] = sol[:, 0, :]
                solved[det_ok] = True
        # fallback: Gaussian-weighted mean
        fb = ~solved
        if fb.any():
            wsum = w[fb].sum(axis=1)
            wmean = (w[fb, :, None] * vk[fb]).sum(axis=1) / np.maximum(
                wsum[:, None], 1e-30)
            out[fb] = np.where(wsum[:, None] > 0, wmean, 0.0)
        # exact hits return the nearest sample value directly
        if exact.any():
            nearest = r2k.argmin(axis=1)
            out[exact] = vk[exact, nearest[exact]]
        return out
