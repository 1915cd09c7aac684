"""Frame rendering on the device the fields live on: the torch counterpart
of `latticeurbanwind_tpu/run/render_jax.py`.

The reference renders every snapshot frame in-device (graphics kernels,
kernel.cpp:2642-3200, invoked per event from setup.cpp:4843-4861).  The
numpy renderer in `render.py` needs u and the flags on the host, a
multi-GB device-to-host copy per frame at production grids; here the march
over a label grid (0 empty / 1 solid / 2 Q-isosurface), fused with the
VIS_FIELD volumetric accumulation (the weighted mean of
`fieldvis.raycast_field`), the Lambert shading and the streamline
integration run as torch operations on the fields' device.  Only the
(H, W, 3) image, the depth buffer and the streamline polylines come to the
host, where `render.py`'s composition rasterises the streamlines and
writes the PNG.

Plain torch on any device (the JAX side is XLA, not Pallas): the same
algorithm as the numpy marcher (step length, first-hit rule, shading
constants), so the images agree to sampling jitter.  JAX's `while_loop`
becomes a loop over the steps that asks the device whether any ray is
still active once every `CHECK_EVERY` steps (a step with no active ray
changes nothing), its `scan` a loop.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..io.png import write_png
from .fieldvis import colorscale_rainbow
from .render import (
    Camera, _camera_rays, default_seeds, draw_segments, streamline_segments,
)

STEP = 0.7                       # cells per march step (render._march)
CHECK_EVERY = 16                 # march steps between two active.any() reads


def _box_blur(occ: torch.Tensor) -> torch.Tensor:
    """3-wide box blur along every axis (render._smooth_occupancy)."""
    for axis in range(3):
        occ = (torch.roll(occ, 1, axis) + occ + torch.roll(occ, -1, axis)) / 3.0
    return occ


def _march_trace(label: torch.Tensor, scalar: torch.Tensor,
                 origins: torch.Tensor, dirs: torch.Tensor, w_half: float,
                 *, n_steps: int, with_field: bool):
    """Lock-step first-hit march + volumetric accumulation.

    label: (Z, Y, X) int8 — 0 empty, >0 opaque layer id (first hit wins).
    scalar: (Z, Y, X) f32 field samples for the volume overlay (|u| etc.).
    w_half: the velocity-mode weight pivot 0.5/scale
      (kernel.cpp:2815: weight = min(v, |v - 0.5/scale|)).
    origins (N, 3) and dirs (3,) or (N, 3) f32 on label's device.
    Returns (hit_label (N,) int8, t_hit (N,) f32, hit_pos (N, 3) f32,
             wsum (N,), vsum (N,), steps_in (N,) int32).
    """
    Z, Y, X = label.shape
    dev = label.device
    n = origins.shape[0]
    dv = dirs if dirs.dim() == 2 else dirs.expand(n, 3)
    dims = torch.tensor([X, Y, Z], dtype=torch.float32, device=dev)
    inv = torch.where(dv.abs() > 1e-12, 1.0 / dv,
                      torch.full_like(dv, float("inf")))
    t0 = (0.0 - origins) * inv
    t1 = (dims[None, :] - 1.0 - origins) * inv
    t_lo = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=0.0)
    t_hi = torch.maximum(t0, t1).amin(dim=1)

    flat = label.reshape(-1)
    sflat = scalar.reshape(-1)
    cap = torch.tensor([X - 1, Y - 1, Z - 1], device=dev)
    t = t_lo
    active = t_hi > t_lo
    hit_label = torch.zeros(n, dtype=torch.int8, device=dev)
    t_hit = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    hit_pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros(n, dtype=torch.float32, device=dev)
    vsum = torch.zeros(n, dtype=torch.float32, device=dev)
    steps_in = torch.zeros(n, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(int(n_steps)):
        if i % CHECK_EVERY == 0 and not bool(active.any()):
            break
        pos = origins + t[:, None] * dv
        ijk = torch.minimum(torch.round(pos).to(torch.int64).clamp(min=0),
                            cap[None, :])
        lin = (ijk[:, 2] * Y + ijk[:, 1]) * X + ijk[:, 0]
        lab = flat[lin]
        newly = active & (lab > 0)
        hit_label = torch.where(newly, lab, hit_label)
        t_hit = torch.where(newly, t, t_hit)
        hit_pos = torch.where(newly[:, None], pos, hit_pos)
        if with_field:
            v = sflat[lin]
            empty = active & (lab == 0)
            w = torch.where(empty, torch.minimum(v, (v - w_half).abs()), zero)
            wsum = wsum + w
            vsum = vsum + w * v
            steps_in = steps_in + empty.to(torch.int32)
        active = active & ~newly & (t + STEP <= t_hi)
        t = t + STEP
    return hit_label, t_hit, hit_pos, wsum, vsum, steps_in


def _shade_hits(occ: torch.Tensor, hit_pos: torch.Tensor, t_hit: torch.Tensor,
                base_rgb: torch.Tensor, hit_label: torch.Tensor,
                diag: float) -> torch.Tensor:
    """Lambert + depth fog at hit points (render._shade, same constants)."""
    Z, Y, X = occ.shape
    dev = occ.device
    flat = occ.reshape(-1)
    lo = torch.tensor(1, device=dev)
    hi = torch.tensor([X - 2, Y - 2, Z - 2], device=dev)
    p = torch.minimum(torch.maximum(torch.round(hit_pos).to(torch.int64), lo),
                      hi[None, :])

    def at(dx, dy, dz):
        lin = ((p[:, 2] + dz) * Y + (p[:, 1] + dy)) * X + (p[:, 0] + dx)
        return flat[lin]

    g = torch.stack([at(1, 0, 0) - at(-1, 0, 0),
                     at(0, 1, 0) - at(0, -1, 0),
                     at(0, 0, 1) - at(0, 0, -1)], dim=1)
    nrm = -g / torch.clamp(torch.linalg.norm(g, dim=1, keepdim=True), min=1e-6)
    light = torch.tensor([0.5, -0.3, 0.8], dtype=torch.float32, device=dev)
    light = light / torch.linalg.norm(light)
    lam = torch.clamp(nrm @ light, 0.0, 1.0) * 0.75 + 0.25
    fog = torch.clamp(1.0 - 0.25 * (t_hit / (2.0 * diag)), 0.0, 1.0)
    rgb = base_rgb[hit_label.to(torch.int64).clamp(0, base_rgb.shape[0] - 1)]
    return rgb * (lam * fog)[:, None]


def _streamlines_device(u: torch.Tensor, seeds: torch.Tensor,
                        solid: torch.Tensor, *, n_steps: int = 250,
                        dt: float = 0.8):
    """Midpoint-RK2 streamline integration on the fields' device
    (render.integrate_streamlines, reference kernel.cpp:2952-3007).
    Returns (paths (S+1, N, 3), speeds (S+1, N)), NaN past a line's end."""
    Z, Y, X = solid.shape
    dev = solid.device
    dims = torch.tensor([X, Y, Z], dtype=torch.float32, device=dev)
    cap = torch.tensor([X - 1, Y - 1, Z - 1], device=dev)
    uf = u.reshape(3, -1)
    sflat = solid.reshape(-1)
    nan = torch.tensor(float("nan"), device=dev)

    def vel_at(p):
        ijk = torch.minimum(torch.round(p).to(torch.int64).clamp(min=0),
                            cap[None, :])
        lin = (ijk[:, 2] * Y + ijk[:, 1]) * X + ijk[:, 0]
        return uf[:, lin].T, sflat[lin]

    p = seeds.to(torch.float32)
    alive = torch.ones(seeds.shape[0], dtype=torch.bool, device=dev)
    paths = [p]
    speeds = [torch.linalg.norm(vel_at(p)[0], dim=1)]
    for _ in range(int(n_steps)):
        v1, _ = vel_at(p)
        sp = torch.linalg.norm(v1, dim=1, keepdim=True)
        v2, _ = vel_at(p + 0.5 * v1 / torch.clamp(sp, min=1e-9) * dt)
        sp2 = torch.linalg.norm(v2, dim=1, keepdim=True)
        p_new = p + v2 / torch.clamp(sp2, min=1e-9) * dt
        inside = ((p_new >= 0) & (p_new <= dims[None, :] - 1)).all(dim=1)
        _, in_solid = vel_at(p_new)
        alive = alive & inside & ~in_solid & (sp[:, 0] > 1e-9)
        p = torch.where(alive[:, None], p_new, p)
        spd = torch.linalg.norm(vel_at(p)[0], dim=1)
        paths.append(torch.where(alive[:, None], p, nan))
        speeds.append(torch.where(alive, spd, nan))
    return torch.stack(paths), torch.stack(speeds)


def percentile(x: torch.Tensor, q: float) -> float:
    """numpy's default (linear) percentile of a flat tensor, on its device."""
    v = torch.sort(x.reshape(-1).to(torch.float32)).values
    pos = (q / 100.0) * (v.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    a, b = float(v[lo]), float(v[hi])
    return a + (b - a) * (pos - lo)


def render_scene_device(solid: torch.Tensor, u: Optional[torch.Tensor],
                        out_path: Path, *, q: Optional[torch.Tensor] = None,
                        q_threshold: Optional[float] = None,
                        cam: Optional[Camera] = None, title: str = "",
                        streamlines: bool = True, u_factor: float = 1.0,
                        volume_mode: bool = False,
                        field_scale: Optional[float] = None,
                        opacity_gain: float = 1.0) -> Path:
    """`render.render_scene` with flags/u/q on their device.

    solid: (Z, Y, X) bool tensor; u: (3, Z, Y, X) or None; q: optional
    precomputed Q field on the same device.  `volume_mode=True` adds the
    VIS_FIELD |u| volumetric haze (graphics_field_rt analog) in the same
    march.  No decimation: only the image leaves the device.
    """
    cam = cam or Camera()
    dev = solid.device
    shape = tuple(solid.shape)
    Z, Y, X = shape
    diag = float(np.linalg.norm([X, Y, Z]))

    label = solid.to(torch.int8)
    if q is not None and q_threshold is not None:
        label = torch.where((q > q_threshold) & ~solid,
                            torch.tensor(2, dtype=torch.int8, device=dev), label)
    occ = _box_blur((label > 0).to(torch.float32))

    scalar = torch.zeros(shape, dtype=torch.float32, device=dev)
    w_half = 0.0
    with_field = bool(volume_mode and u is not None)
    if with_field:
        scalar = torch.sqrt((u.to(torch.float32) ** 2).sum(0))
        if field_scale is None:
            field_scale = 1.0 / max(percentile(scalar, 99.5), 1e-9)
        w_half = 0.5 / field_scale

    origins, dirs, _ = _camera_rays(shape, cam)
    n_steps = int(np.ceil(2.0 * diag / STEP)) + 2
    hit_label, t_hit, hit_pos, wsum, vsum, steps_in = _march_trace(
        label, scalar, torch.from_numpy(origins).to(dev),
        torch.from_numpy(dirs).to(dev), w_half, n_steps=n_steps,
        with_field=with_field)

    base_rgb = torch.tensor([[1.0, 1.0, 1.0],        # 0: background
                             [0.55, 0.55, 0.6],      # 1: solid
                             [0.85, 0.3, 0.15]],     # 2: Q isosurface
                            dtype=torch.float32, device=dev)
    shaded = _shade_hits(occ, hit_pos, t_hit, base_rgb, hit_label, diag)
    img = torch.where((hit_label > 0)[:, None], shaded,
                      torch.ones((1, 3), dtype=torch.float32, device=dev))
    if with_field:
        mean = torch.where(wsum > 0, vsum / torch.clamp(wsum, min=1e-12),
                           torch.zeros_like(wsum))
        rgb_v = torch.from_numpy(colorscale_rainbow(
            (field_scale * mean).cpu().numpy())).to(dev)
        alpha = torch.clamp((wsum * 2.0 * field_scale * opacity_gain - 1.0)
                            / torch.clamp(steps_in, min=1), 0.0, 1.0)
        img = rgb_v * alpha[:, None] + img * (1.0 - alpha[:, None])

    # host composition: image-sized data only
    img_np = np.clip(img.cpu().numpy().reshape(cam.height, cam.width, 3),
                     0.0, 1.0)
    depth_np = t_hit.cpu().numpy().reshape(cam.height, cam.width)
    if streamlines and u is not None:
        seeds = default_seeds(shape, None)
        if len(seeds):
            paths, speeds = _streamlines_device(
                u.to(torch.float32), torch.from_numpy(seeds).to(dev), solid,
                n_steps=250)
            draw_segments(img_np, *streamline_segments(
                paths.cpu().numpy(), speeds.cpu().numpy(), shape, cam,
                depth_np, u_factor))
    return write_png(out_path, img_np, title)


def q_criterion_device(u: torch.Tensor) -> torch.Tensor:
    """Q-criterion on the fields' device in f32 (snapshots.q_criterion,
    kernel.cpp:933-955)."""
    u = u.to(torch.float32)

    def d(comp, axis):
        return 0.5 * (torch.roll(comp, -1, axis) - torch.roll(comp, 1, axis))

    dudx, dudy, dudz = d(u[0], 2), d(u[0], 1), d(u[0], 0)
    dvdx, dvdy, dvdz = d(u[1], 2), d(u[1], 1), d(u[1], 0)
    dwdx, dwdy, dwdz = d(u[2], 2), d(u[2], 1), d(u[2], 0)
    omega2 = (dudy - dvdx) ** 2 + (dudz - dwdx) ** 2 + (dvdz - dwdy) ** 2
    s2 = (2.0 * (dudx ** 2 + dvdy ** 2 + dwdz ** 2)
          + (dudy + dvdx) ** 2 + (dudz + dwdx) ** 2 + (dvdz + dwdy) ** 2)
    return 0.25 * (omega2 - s2)
