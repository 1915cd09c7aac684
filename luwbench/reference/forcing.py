"""Precomputed spatial forcing fields: lateral buffer nudging + top sponge.

Counterpart of `latticeurbanwind_tpu/lbm/forcing.py`, which reproduces the
reference's in-kernel band geometry (kernel.cpp:1523-1614).  The band
geometry is built once per case in numpy and then moved to the device.

Face ids: 0=west(x=0), 1=east(x=Nx-1), 2=south(y=0), 3=north(y=Ny-1),
4=top(z=Nz-1).  Downstream ids follow the reference convention
(1=west .. 4=north, 0=none) in `NudgeSpec.downstream_face`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .state import Forcing


@dataclass(frozen=True)
class NudgeSpec:
    n_cells: int
    inv_tau: float              # 1/tau in lattice units per step
    vertical: bool = False
    downstream_face: int = 0    # 0 none, 1 west, 2 east, 3 south, 4 north


@dataclass(frozen=True)
class SpongeSpec:
    n_cells: int
    inv_tau: float
    ref_mode: int = 0


def build_nudge_fields(shape: Tuple[int, int, int], spec: NudgeSpec):
    """(sigma, face) numpy arrays for the nudging band: every cell within
    `n_cells` of an active face relaxes toward that face's boundary value
    with weight sin^2(pi/2 (1 - d/N)); the nearest face wins, ties broken in
    the order west, east, south, north, top."""
    Z, Y, X = shape
    z, y, x = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X), indexing="ij")
    nbuf = spec.n_cells
    INF = nbuf + 1

    d = np.stack([
        x if spec.downstream_face != 1 else np.full(shape, INF),            # west
        (X - 1 - x) if spec.downstream_face != 2 else np.full(shape, INF),  # east
        y if spec.downstream_face != 3 else np.full(shape, INF),            # south
        (Y - 1 - y) if spec.downstream_face != 4 else np.full(shape, INF),  # north
        Z - 1 - z,                                                          # top
    ]).astype(np.int64)
    d = np.where(d > nbuf, INF, d)

    key = d * 8 + np.arange(5)[:, None, None, None]
    face = np.argmin(key, axis=0).astype(np.uint8)
    d_min = np.min(d, axis=0)

    in_band = d_min <= nbuf
    xi = 1.0 - d_min.astype(np.float64) / float(nbuf)
    w_buf = np.sin(0.5 * np.pi * xi) ** 2
    sigma = np.where(in_band, w_buf * spec.inv_tau, 0.0).astype(np.float32)
    return sigma, face


def build_sponge_profile(nz: int, spec: SpongeSpec) -> np.ndarray:
    """1-D sigma(z) anchored at the first interior cell below the top
    boundary (d = (Nz-2) - z, active for 0 <= d < n_cells)."""
    z = np.arange(nz)
    d = (nz - 2) - z
    ns = spec.n_cells
    xi = 1.0 - d.astype(np.float64) / float(max(ns - 1, 1)) if ns > 1 else np.ones(nz)
    if ns == 1:
        xi = np.where(d == 0, 1.0, 0.0)
    sig = spec.inv_tau * np.sin(0.5 * np.pi * xi) ** 2
    sig = np.where((d >= 0) & (d < ns), sig, 0.0)
    return sig.astype(np.float32)


def build_forcing(
    shape: Tuple[int, int, int],
    nudge: Optional[NudgeSpec] = None,
    sponge: Optional[SpongeSpec] = None,
    *,
    device: torch.device | str = "cpu",
) -> Forcing:
    nudge_sigma = nudge_face = sponge_sigma = None
    vertical = False
    if nudge is not None and nudge.n_cells > 0 and nudge.inv_tau > 0:
        sigma, face = build_nudge_fields(shape, nudge)
        nudge_sigma = torch.tensor(sigma, device=device)
        nudge_face = torch.tensor(face, device=device)
        vertical = nudge.vertical
    if sponge is not None and sponge.n_cells > 0 and sponge.inv_tau > 0:
        sponge_sigma = torch.tensor(build_sponge_profile(shape[0], sponge),
                                    device=device)
    return Forcing(
        nudge_sigma=nudge_sigma,
        nudge_face=nudge_face,
        nudge_vertical=vertical,
        sponge_sigma_z=sponge_sigma,
    )
