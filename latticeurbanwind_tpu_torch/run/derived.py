"""Derived turbulence fields for the averaged VTK: tke, TI, TLS.

Formulas match the reference avg-VTK writer (setup.cpp:2596-2676):
  tke = 0.5 * (var_u + var_v + var_w)           [written in SI via u_factor^2]
  TI  = sqrt(var_sum/3) / |u_mean|              [dimensionless]
  TLS = sqrt(k_SI) / |S_SI|, |S| = sqrt(2 Sij Sij) from one-sided-clamped
        central differences of the SI mean velocity; capped at max(N)*dx.
All zero on solid cells and when fewer than 2 samples were accumulated.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..lbm.state import TYPE_S


def derived_turbulence_fields(
    mean_u: np.ndarray,        # (3, Z, Y, X) lattice units
    var_sum_in: np.ndarray,    # (Z, Y, X) variance TRACE var_u+var_v+var_w,
    #                            lattice units^2 (welford.variance_sum_u)
    flags: np.ndarray,         # (Z, Y, X)
    *,
    avg_count: int,
    u_factor: float,           # SI m/s per lattice unit
    spacing: float,            # SI m per cell
    want=("tke", "ti", "tls"),
) -> Dict[str, np.ndarray]:
    Z, Y, X = flags.shape
    solid = (flags & TYPE_S) != 0
    out: Dict[str, np.ndarray] = {}
    fluid = (~solid).astype(np.float32)
    out["fluid"] = fluid
    has_m2 = avg_count > 1
    var_sum = (np.asarray(var_sum_in) if has_m2
               else np.zeros((Z, Y, X), np.float32))
    # cells where derived fields are defined (note: has_m2 is a Python bool;
    # never fold it into numpy bitwise ops)
    invalid = solid if has_m2 else np.ones_like(solid, dtype=bool)

    if "tke" in want:
        tke = 0.5 * var_sum * (u_factor * u_factor)
        out["tke"] = np.where(invalid, 0.0, tke).astype(np.float32)

    if "ti" in want:
        umag = np.sqrt((mean_u ** 2).sum(axis=0))
        urms = np.sqrt(var_sum / 3.0)
        ti = np.where((umag > 1e-9) & (var_sum > 0), urms / np.maximum(umag, 1e-30), 0.0)
        out["TI"] = np.where(invalid, 0.0, ti).astype(np.float32)

    if "tls" in want:
        u_si = mean_u * u_factor
        dx = max(spacing, 1e-12)

        def grad(comp, axis):
            # one-sided at the domain edge, central inside (clamped indices)
            g = np.zeros_like(comp)
            n = comp.shape[axis]
            if n < 2:
                return g
            sl = [slice(None)] * 3
            sp, sm = list(sl), list(sl)
            sp[axis] = slice(2, None)
            sm[axis] = slice(0, -2)
            ctr = list(sl)
            ctr[axis] = slice(1, -1)
            g[tuple(ctr)] = (comp[tuple(sp)] - comp[tuple(sm)]) / (2.0 * dx)
            first, second = list(sl), list(sl)
            first[axis] = 0
            second[axis] = 1
            g[tuple(first)] = (comp[tuple(second)] - comp[tuple(first)]) / dx
            last, prev = list(sl), list(sl)
            last[axis] = n - 1
            prev[axis] = n - 2
            g[tuple(last)] = (comp[tuple(last)] - comp[tuple(prev)]) / dx
            return g

        # axes: 0=z, 1=y, 2=x; du[i][j] = d u_i / d x_j with x_j in (x,y,z)
        d = {}
        for i, axis_name in enumerate("uvw"):
            d[(i, 0)] = grad(u_si[i], 2)   # d/dx
            d[(i, 1)] = grad(u_si[i], 1)   # d/dy
            d[(i, 2)] = grad(u_si[i], 0)   # d/dz
        Sxx, Syy, Szz = d[(0, 0)], d[(1, 1)], d[(2, 2)]
        Sxy = 0.5 * (d[(0, 1)] + d[(1, 0)])
        Sxz = 0.5 * (d[(0, 2)] + d[(2, 0)])
        Syz = 0.5 * (d[(1, 2)] + d[(2, 1)])
        smag = np.sqrt(np.maximum(
            0.0, 2.0 * (Sxx**2 + Syy**2 + Szz**2 + 2.0 * (Sxy**2 + Sxz**2 + Syz**2))))
        k_si = 0.5 * var_sum * (u_factor * u_factor)
        tls = np.where((smag > 1e-10) & (k_si > 0), np.sqrt(np.maximum(k_si, 0)) / np.maximum(smag, 1e-30), 0.0)
        cap = max(X, Y, Z) * dx
        out["TLS"] = np.where(invalid, 0.0, np.clip(tls, 0.0, cap)).astype(np.float32)

    return out
