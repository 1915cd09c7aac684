"""Binary STL mesh I/O (numpy-vectorized).

Replaces the reference's host-side Mesh/STL loader
(reference: utilities.hpp:4835-4899, used by setup.cpp:4001-4093).  Handles
the 80-byte header + uint32 count + 50-byte triangle records; also reads
ASCII STL as a fallback.  Scaling/centering mirror the solver's mesh fit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class Mesh:
    """Triangle soup: vertices (T, 3, 3) float32 (triangle, corner, xyz)."""

    tris: np.ndarray

    @property
    def pmin(self) -> np.ndarray:
        return self.tris.reshape(-1, 3).min(axis=0)

    @property
    def pmax(self) -> np.ndarray:
        return self.tris.reshape(-1, 3).max(axis=0)

    @property
    def size(self) -> np.ndarray:
        return self.pmax - self.pmin

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.pmin + self.pmax)

    def translated(self, offset) -> "Mesh":
        return Mesh(self.tris + np.asarray(offset, dtype=np.float32))

    def scaled(self, factor: float, about=None) -> "Mesh":
        about = self.center if about is None else np.asarray(about, dtype=np.float32)
        return Mesh((self.tris - about) * np.float32(factor) + about)

    def rotated_z(self, angle_deg: float, about=None) -> "Mesh":
        """Rotate around the vertical axis (degrees, counter-clockwise)."""
        about = self.center if about is None else np.asarray(about, dtype=np.float32)
        a = np.deg2rad(angle_deg)
        R = np.array([[np.cos(a), -np.sin(a), 0.0],
                      [np.sin(a), np.cos(a), 0.0],
                      [0.0, 0.0, 1.0]], dtype=np.float32)
        return Mesh((self.tris - about) @ R.T + about)


def read_stl(path: Path | str) -> Mesh:
    raw = Path(path).read_bytes()
    if len(raw) >= 84:
        (count,) = struct.unpack_from("<I", raw, 80)
        if 84 + 50 * count == len(raw):
            rec = np.frombuffer(raw, dtype=np.uint8, count=50 * count, offset=84)
            rec = rec.reshape(count, 50)
            floats = rec[:, :48].copy().view("<f4").reshape(count, 4, 3)
            return Mesh(tris=floats[:, 1:4, :].astype(np.float32))
    # ASCII fallback
    text = raw.decode("utf-8", errors="ignore")
    if "facet" not in text:
        raise ValueError(f"not an STL file: {path}")
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            verts.append([float(v) for v in parts[1:]])
    arr = np.asarray(verts, dtype=np.float32)
    if arr.size == 0 or len(arr) % 3:
        raise ValueError(f"malformed ASCII STL: {path}")
    return Mesh(tris=arr.reshape(-1, 3, 3))


def write_stl(path: Path | str, mesh: Mesh, header: str = "latticeurbanwind_tpu") -> None:
    tris = np.asarray(mesh.tris, dtype="<f4")
    count = len(tris)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-30), 0.0).astype("<f4")
    rec = np.zeros((count, 50), dtype=np.uint8)
    block = np.concatenate([n[:, None, :], tris], axis=1)  # (T, 4, 3) normal + vertices
    rec[:, :48] = np.ascontiguousarray(block, dtype="<f4").reshape(count, 12).view(np.uint8)
    with open(path, "wb") as fh:
        fh.write(header.encode()[:80].ljust(80, b"\0"))
        fh.write(struct.pack("<I", count))
        fh.write(rec.tobytes())
