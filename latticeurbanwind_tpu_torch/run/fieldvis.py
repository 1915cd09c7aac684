"""Field visualization: the reference's VIS_FIELD family.

A copy of `latticeurbanwind_tpu/run/fieldvis.py` (numpy only): the port
keeps its own copy of what it needs from the JAX package.

The reference renders fields three ways (kernel.cpp):
  * ``graphics_field_rt`` (kernel.cpp:2864-2888) — a volumetric raycast
    that accumulates a deviation-weighted mean of the field along each
    pixel ray (``ray_grid_traverse_sum``, kernel.cpp:2786-2862) and blends
    the colorscaled mean over the background with an opacity proportional
    to the traversed weight;
  * ``graphics_field_slice`` (kernel.cpp:2890-2950) — an axis-aligned
    slice plane embedded in the 3-D scene, colored per cell and
    depth-tested against the geometry;
  * ``graphics_field`` (kernel.cpp:2755-2784) — per-cell velocity ticks
    (covered here by the quiver overlays of gui/server + post tools).

Field color modes match the reference exactly (kernel.cpp:2776-2780):
mode ``u`` = rainbow(scale_u * |u|), ``rho`` = twocolor(0.5 + scale_rho *
(rho - 1)), ``T`` = iron(0.5 + scale_T * (T - T_avg)).  The colorscales
reproduce the reference ramps (kernel.cpp:112-156) as vectorized numpy.

This is the CPU/frame analog of the in-device OpenCL renderer; grids are
decimated upstream (run/render.render_scene) so frame times stay in
seconds at 100M+ cells.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------- colorscales

def colorscale_rainbow(x: np.ndarray) -> np.ndarray:
    """[0, 1] -> RGB float (..., 3): black-violet-blue-cyan-green-yellow-red.

    Same ramp as the reference's colorscale_rainbow (kernel.cpp:112-135),
    evaluated on the flipped coordinate t = clamp(6 (1 - x), 0, 6)."""
    t = np.clip(6.0 * (1.0 - np.asarray(x, np.float32)), 0.0, 6.0)
    r = np.select(
        [t < 1.2, t < 2.0, t < 3.0, t < 4.0, t < 5.0],
        [1.0, 2.5 - t * 1.25, 0.0, 0.0, t * 0.4 - 1.6],
        default=2.4 - t * 0.4)
    g = np.select(
        [t < 1.2, t < 2.0, t < 3.0, t < 4.0],
        [t * 0.83333333, 1.0, 1.0, 4.0 - t],
        default=0.0)
    b = np.select(
        [t < 2.0, t < 3.0, t < 4.0],
        [0.0, t - 2.0, 1.0],
        default=3.0 - t * 0.5)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


def colorscale_iron(x: np.ndarray) -> np.ndarray:
    """[0, 1] -> RGB: black-violet-red-yellow-white (kernel.cpp:136-152)."""
    t = np.clip(4.0 * (1.0 - np.asarray(x, np.float32)), 0.0, 4.0)
    r = np.where(t < 2.0, 1.0, 2.0 - t * 0.5)
    g = np.select([t < 0.66666667, t < 2.0], [1.0, 1.5 - t * 0.75],
                  default=0.0)
    b = np.select([t < 0.66666667, t < 2.0, t < 3.0],
                  [1.0 - t * 1.5, 0.0, t - 2.0],
                  default=4.0 - t)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


def colorscale_twocolor(x: np.ndarray,
                        background=(0.0, 0.0, 0.0)) -> np.ndarray:
    """[0, 1] -> RGB: blue - background - orange (kernel.cpp:153-156).

    x > 0.5 mixes background toward 0xFFAA00 by 2x-1; x <= 0.5 mixes
    0x0080FF toward background by 2x."""
    x = np.asarray(x, np.float32)
    bg = np.asarray(background, np.float32)
    hot = np.array([1.0, 2.0 / 3.0, 0.0], np.float32)    # 0xFFAA00
    cold = np.array([0.0, 0.5, 1.0], np.float32)         # 0x0080FF
    a_hot = np.clip(2.0 * x - 1.0, 0.0, 1.0)[..., None]
    a_cold = np.clip(2.0 * x, 0.0, 1.0)[..., None]
    up = hot * a_hot + bg * (1.0 - a_hot)
    dn = bg * a_cold + cold * (1.0 - a_cold)
    return np.where((x > 0.5)[..., None], up, dn).astype(np.float32)


FIELD_MODES = ("u", "rho", "T")


def field_color(values: np.ndarray, mode: str, scale: float,
                t_avg: float = 0.0, background=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Colorscale dispatch for scalar samples of the given field mode
    (reference switch, kernel.cpp:2776-2780)."""
    if mode == "u":
        return colorscale_rainbow(scale * values)
    if mode == "rho":
        return colorscale_twocolor(0.5 + scale * (values - 1.0), background)
    if mode == "T":
        return colorscale_iron(0.5 + scale * (values - t_avg))
    raise ValueError(f"unknown field mode {mode!r} (want one of {FIELD_MODES})")


def field_weight(values: np.ndarray, mode: str, scale: float,
                 t_avg: float = 0.0) -> np.ndarray:
    """Deviation weight of a sample — what makes uniform regions
    transparent in the volumetric mean (kernel.cpp:2815-2818 velocity,
    :2833-2835 density, :2847-2850 temperature)."""
    if mode == "u":
        return np.minimum(values, np.abs(values - 0.5 / max(scale, 1e-12)))
    if mode == "rho":
        return np.abs(values - 1.0)
    if mode == "T":
        return (values - t_avg) ** 2
    raise ValueError(f"unknown field mode {mode!r}")


def auto_scale(values: np.ndarray, mode: str) -> float:
    """Default def_scale_* when the caller gives none: map the observed
    range into the colorscale's [0, 1] (the reference scales are user
    settings, graphics.hpp; auto-ranging is the frame-tool equivalent)."""
    finite = values[np.isfinite(values)]
    if finite.size == 0:
        return 1.0
    if mode == "u":
        top = float(np.percentile(finite, 99.5))
        return 1.0 / max(top, 1e-9)
    if mode == "rho":
        dev = float(np.percentile(np.abs(finite - 1.0), 99.5))
        return 0.5 / max(dev, 1e-9)
    dev = float(np.percentile(np.abs(finite - np.mean(finite)), 99.5))
    return 0.5 / max(dev, 1e-9)


# ------------------------------------------------------------ volume raycast

def raycast_field(scalar: np.ndarray, origins: np.ndarray, dirs: np.ndarray,
                  *, mode: str = "u", scale: Optional[float] = None,
                  t_avg: float = 0.0, exclude: Optional[np.ndarray] = None,
                  background: Optional[np.ndarray] = None,
                  opacity_gain: float = 1.0, step: float = 0.7,
                  geom_depth: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Volumetric weighted-mean raycast of a scalar field.

    The frame-tool analog of ray_grid_traverse_sum + graphics_field_rt
    (kernel.cpp:2786-2888): every ray accumulates ``sum += w * v`` and
    ``wsum += w`` over in-grid samples (deviation weight per mode), colors
    the weighted mean through the mode's colorscale, and alpha-blends over
    the background with opacity ~ traversed weight.  The reference walks
    exact cell crossings (DDA); sampling at a fixed sub-cell step gives
    the same integral on smooth LES fields and vectorizes over all rays.

    scalar: (Z, Y, X) field samples (|u| for mode 'u').
    origins/dirs: from render._camera_rays — dirs (3,) shared or (N, 3).
    exclude: (Z, Y, X) bool — cells skipped (solid/equilibrium,
      kernel.cpp:2813 flags & (TYPE_S|TYPE_E|TYPE_G)).
    geom_depth: (N,) existing depth buffer — samples behind it are
      occluded so geometry stays visible through the haze.
    Returns (rgb (N, 3), alpha (N,)).
    """
    Z, Y, X = scalar.shape
    n = len(origins)
    per_ray = np.ndim(dirs) == 2
    dv = dirs if per_ray else np.broadcast_to(dirs, (n, 3))
    dims = np.array([X, Y, Z], np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(np.abs(dv) > 1e-12, 1.0 / dv, np.inf)
        t0 = (0.0 - origins) * inv
        t1 = (dims[None, :] - 1.0 - origins) * inv
    t_lo = np.maximum(np.minimum(t0, t1).max(axis=1), 0.0).astype(np.float32)
    t_hi = np.maximum(t0, t1).min(axis=1).astype(np.float32)
    if geom_depth is not None:
        t_hi = np.minimum(t_hi, geom_depth.astype(np.float32))
    span = np.maximum(t_hi - t_lo, 0.0)
    alive = span > 0
    n_steps = int(np.ceil(float(span.max(initial=0.0)) / step)) + 1
    if scale is None:
        scale = auto_scale(scalar if exclude is None else scalar[~exclude],
                           mode)
    wsum = np.zeros(n, np.float32)
    vsum = np.zeros(n, np.float32)
    steps_in = np.zeros(n, np.int32)
    idx_cap = np.array([X - 1, Y - 1, Z - 1])
    t = t_lo.copy()
    pos = origins + t[:, None] * dv
    active = alive.copy()
    for _ in range(n_steps):
        act = np.nonzero(active)[0]
        if not len(act):
            break
        p = pos[act]
        ijk = np.clip(np.round(p).astype(np.int64), 0, idx_cap)
        zz, yy, xx = ijk[:, 2], ijk[:, 1], ijk[:, 0]
        v = scalar[zz, yy, xx].astype(np.float32)
        ok = np.ones(len(act), bool) if exclude is None else ~exclude[zz, yy, xx]
        w = np.where(ok, field_weight(v, mode, scale, t_avg), 0.0)
        wsum[act] += w
        vsum[act] += w * v
        steps_in[act] += 1
        t[act] += step
        pos[act] += dv[act] * step
        active[act] = t[act] <= t_hi[act]
    mean = np.where(wsum > 0, vsum / np.maximum(wsum, 1e-12), 0.0)
    rgb = field_color(mean, mode, scale, t_avg)
    # opacity = clamp((weighted - 1) / steps) with the reference's per-mode
    # weight rescale folded into opacity_gain (kernel.cpp:2829,2843,2857-2860)
    mode_gain = {"u": 2.0 * scale, "rho": scale, "T": (4.0 * scale) ** 2}[mode]
    alpha = np.clip((wsum * mode_gain * opacity_gain - 1.0)
                    / np.maximum(steps_in, 1), 0.0, 1.0).astype(np.float32)
    alpha[~alive] = 0.0
    if background is not None:
        rgb = rgb * alpha[:, None] + background * (1.0 - alpha[:, None])
    return rgb.astype(np.float32), alpha


# ----------------------------------------------------------- embedded slice

def slice_plane(scalar: np.ndarray, axis: int, index: int,
                origins: np.ndarray, dirs: np.ndarray, *,
                mode: str = "u", scale: Optional[float] = None,
                t_avg: float = 0.0,
                exclude: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Axis-aligned colored slice plane seen through the camera rays.

    graphics_field_slice analog (kernel.cpp:2890-2950): the reference
    rasterizes two triangles per cell of the slice; here each pixel ray is
    intersected with the plane and the field is sampled bilinearly at the
    hit — same image, one vectorized pass.

    axis: 0 = z-plane (slice_mode 3), 1 = y, 2 = x (world axis held fixed).
    Returns (hit (N,), t (N,), rgb (N, 3)).
    """
    Z, Y, X = scalar.shape
    dims = np.array([X, Y, Z], np.float32)
    world_ax = {0: 2, 1: 1, 2: 0}[axis]      # component of (x, y, z) vectors
    n = len(origins)
    per_ray = np.ndim(dirs) == 2
    dv = dirs if per_ray else np.broadcast_to(dirs, (n, 3))
    denom = dv[:, world_ax]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (float(index) - origins[:, world_ax]) / denom
    p = origins + t[:, None] * dv
    inside = (np.abs(denom) > 1e-9) & (t > 0)
    for c in range(3):
        if c != world_ax:
            inside &= (p[:, c] >= 0) & (p[:, c] <= dims[c] - 1)
    if scale is None:
        scale = auto_scale(scalar if exclude is None else scalar[~exclude],
                           mode)
    # bilinear sample in the slice plane
    pc = np.clip(p, 0, dims[None, :] - 1.0001)
    i0 = np.floor(pc).astype(np.int64)
    f = (pc - i0).astype(np.float32)
    i0[:, world_ax] = index
    f[:, world_ax] = 0.0
    i1 = np.minimum(i0 + 1, (dims - 1).astype(np.int64)[None, :])
    i1[:, world_ax] = index

    def sample(ix, iy, iz):
        return scalar[iz, iy, ix].astype(np.float32)

    # the two in-plane axes are the ones != world_ax
    in_plane = [c for c in range(3) if c != world_ax]
    a, b = in_plane
    corners = {}
    for da in (0, 1):
        for db in (0, 1):
            idx = i0.copy()
            if da:
                idx[:, a] = i1[:, a]
            if db:
                idx[:, b] = i1[:, b]
            corners[(da, db)] = sample(idx[:, 0], idx[:, 1], idx[:, 2])
    fa, fb = f[:, a], f[:, b]
    val = (corners[(0, 0)] * (1 - fa) * (1 - fb)
           + corners[(1, 0)] * fa * (1 - fb)
           + corners[(0, 1)] * (1 - fa) * fb
           + corners[(1, 1)] * fa * fb)
    if exclude is not None:
        ijk = np.clip(np.round(pc).astype(np.int64), 0,
                      (dims - 1).astype(np.int64)[None, :])
        ijk[:, world_ax] = index
        inside &= ~exclude[ijk[:, 2], ijk[:, 1], ijk[:, 0]]
    rgb = field_color(val, mode, scale, t_avg)
    return inside, t.astype(np.float32), rgb
