"""Brute-force nearest-neighbor inlet interpolation: the low-order BC path.

Counterpart of `latticeurbanwind_tpu/bc/nearest.py` (reference
NearestNeighborInterpolator, interpolation.cpp:51-60).  The all-pairs search
is a chunked distance product (|q - s|^2 = |q|^2 + |s|^2 - 2 q.s, one
matmul per chunk) followed by an argmin, in torch on the run's device; the
JAX package computes the same product outside any Pallas kernel.  There is
no second implementation to fall through to: an error on the device raises.
"""

from __future__ import annotations

import numpy as np
import torch


def nearest_neighbor_eval(points: np.ndarray, values: np.ndarray,
                          queries: np.ndarray, *, chunk: int = 65536,
                          device: torch.device | str = "cpu") -> np.ndarray:
    """values[argmin_s |query - point_s|] for each query.

    points (S,3), values (S,C), queries (Q,3) -> (Q,C); the search runs in
    float32 on `device`, the gather on the host in the values' own dtype.
    """
    points = np.asarray(points, dtype=np.float32)
    values = np.asarray(values)
    queries = np.asarray(queries, dtype=np.float32)
    if len(points) == 0:
        return np.zeros((len(queries), values.shape[1] if values.ndim > 1 else 1))

    pts = torch.from_numpy(points).to(device)
    s_norm = (pts * pts).sum(dim=1)
    idx = np.empty(len(queries), dtype=np.int64)
    for start in range(0, len(queries), chunk):
        q = torch.from_numpy(queries[start:start + chunk]).to(device)
        d2 = (q * q).sum(dim=1)[:, None] + s_norm[None] - 2.0 * (q @ pts.T)
        idx[start:start + len(q)] = d2.argmin(dim=1).cpu().numpy()
    return values[idx]
