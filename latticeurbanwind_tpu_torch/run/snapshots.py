"""Offscreen solver snapshots and video frames, and the solid-boundary
force diagnostic.

Counterpart of `latticeurbanwind_tpu/run/snapshots.py` (the reference's
graphics pipeline, graphics.cpp + kernel.cpp:2574-3200, invoked from
run_lbm at setup.cpp:4843-4861 to write PNG frames):

  * `write_snapshot`: three 2-D panels side by side -- |u| on the plane
    z = 2, |u| on the vertical slice y = Y/2 and the Q-criterion's top-down
    maximum projection -- and a companion `<name>_3d.png` (raytraced
    solids, the Q isosurface and streamlines);
  * `write_frame`: one perspective 3-D frame per `frame_output` steps.

The panels and the projection are computed where the fields live: on a
CUDA device (`_render_on_device`; the tensor's device decides) they are
torch operations there and only slices, projections and the finished
image cross to the host (`render_device.py`); otherwise the numpy path runs
(`render.py`), decimating grids above 8M cells as the JAX package's does.
A run split over a mesh hands its gathered host fields to the numpy path.

The JAX package composes the panels with matplotlib (viridis |u|, inferno
Q, colour bars, titles).  The port writes the same arrays without
matplotlib (`io/png.py`): each panel one pixel per cell with y (or z) up,
solid cells black, |u| through `fieldvis.colorscale_rainbow` over [0, the
panel's max] and Q through `colorscale_iron` over [0, its 99.5th
percentile], the title in the PNG's text chunk.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..io.png import write_png
from ..lbm.state import LBMState, TYPE_S, decode_fp16c
from .fieldvis import colorscale_iron, colorscale_rainbow

Q_MAX_CELLS = 8_000_000          # the Q panel's grid is decimated above this
PANEL_GAP = 8                    # white pixels between two panels


def _render_on_device(arr) -> bool:
    """True when the frames render where the fields live: a tensor on a
    CUDA device.  The reference renders every frame in-device
    (setup.cpp:4843-4861); the device path never copies u or the flags to
    the host, only the finished image."""
    return isinstance(arr, torch.Tensor) and arr.device.type == "cuda"


def q_criterion(u: np.ndarray) -> np.ndarray:
    """Q = (||Omega||^2 - ||S||^2)/2 from central differences (lattice units).

    Matches the reference's cached formulation (kernel.cpp:933-955) including
    the extra 1/2 factor from the 2-cell-wide central difference.
    """
    def d(comp, axis):
        return 0.5 * (np.roll(comp, -1, axis) - np.roll(comp, 1, axis))

    # axes: u[c][z, y, x]; derivatives along x=2, y=1, z=0
    dudx, dudy, dudz = d(u[0], 2), d(u[0], 1), d(u[0], 0)
    dvdx, dvdy, dvdz = d(u[1], 2), d(u[1], 1), d(u[1], 0)
    dwdx, dwdy, dwdz = d(u[2], 2), d(u[2], 1), d(u[2], 0)
    omega2 = (dudy - dvdx) ** 2 + (dudz - dwdx) ** 2 + (dvdz - dwdy) ** 2
    s2 = (2.0 * (dudx ** 2 + dvdy ** 2 + dwdz ** 2)
          + (dudy + dvdx) ** 2 + (dudz + dwdx) ** 2 + (dvdz + dwdy) ** 2)
    return 0.25 * (omega2 - s2)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def panel(values: np.ndarray, solid: np.ndarray, ramp, vmax: float) -> np.ndarray:
    """One 2-D panel as an (rows, cols, 3) image: `values` (rows, cols)
    over [0, vmax] through the colour ramp, solid cells black, row 0 at the
    bottom (the JAX package's pcolormesh orientation)."""
    rgb = ramp(np.clip(values / max(float(vmax), 1e-30), 0.0, 1.0))
    rgb[np.asarray(solid, bool)] = 0.0
    return rgb[::-1]


def compose_panels(panels) -> np.ndarray:
    """Panels side by side on white, aligned at the top, PANEL_GAP apart."""
    h = max(p.shape[0] for p in panels)
    w = sum(p.shape[1] for p in panels) + PANEL_GAP * (len(panels) - 1)
    out = np.ones((h, w, 3), np.float32)
    x = 0
    for p in panels:
        out[:p.shape[0], x:x + p.shape[1]] = p
        x += p.shape[1] + PANEL_GAP
    return out


def write_snapshot(state: LBMState, out_path: Path, *, u_factor: float = 1.0,
                   nz_out: int = 0, title: str = "") -> Path:
    """The snapshot PNG at `out_path` and its `<stem>_3d.png` companion."""
    on_device = _render_on_device(state.u)
    if on_device:
        # panels on the device; only slice/projection-sized arrays move
        u_j = state.u
        flags_j = state.flags
        if nz_out:
            u_j = u_j[:, :nz_out]
            flags_j = flags_j[:nz_out]
        Z, Y, X = flags_j.shape
        solid_j = (flags_j & TYPE_S) != 0
        speed_j = torch.sqrt((u_j.to(torch.float32) ** 2).sum(dim=0))
        k = max(1, min(Z - 1, 2))
        jmid = Y // 2
        speed_k = speed_j[k].cpu().numpy() * u_factor
        speed_y = speed_j[:, jmid, :].cpu().numpy() * u_factor
        solid_k = solid_j[k].cpu().numpy()
        solid_y = solid_j[:, jmid, :].cpu().numpy()
    else:
        u = _host(state.u) * u_factor
        flags = _host(state.flags)
        if nz_out:
            u = u[:, :nz_out]
            flags = flags[:nz_out]
        Z, Y, X = flags.shape
        solid = (flags & TYPE_S) != 0
        speed = np.sqrt((u ** 2).sum(axis=0))
        k = max(1, min(Z - 1, 2))
        jmid = Y // 2
        speed_k, speed_y = speed[k], speed[:, jmid, :]
        solid_k, solid_y = solid[k], solid[:, jmid, :]

    # Q panel from a decimated copy above Q_MAX_CELLS (the 18-roll f64
    # stencil is minutes at 100M cells on the host; the projection does
    # not need the full resolution)
    qs = 1
    if on_device:
        from .render_device import q_criterion_device

        solid_jq = (state.flags & TYPE_S) != 0
        q_j = torch.where(solid_jq, torch.zeros((), device=solid_jq.device),
                          q_criterion_device(state.u))
        if q_j.numel() > Q_MAX_CELLS:         # decimate before the copy
            qs = int(np.ceil((q_j.numel() / Q_MAX_CELLS) ** (1.0 / 3.0)))
            q_j = q_j[::qs, ::qs, ::qs]
            solid_jq = solid_jq[::qs, ::qs, ::qs]
        q = q_j.cpu().numpy()
        solid_full = solid_jq.cpu().numpy()
        uq = None
    else:
        uq = _host(state.u)
        solid_full = (_host(state.flags) & TYPE_S) != 0
        if solid_full.size > Q_MAX_CELLS:
            qs = int(np.ceil((solid_full.size / Q_MAX_CELLS) ** (1.0 / 3.0)))
            uq = uq[:, ::qs, ::qs, ::qs]
            solid_full = solid_full[::qs, ::qs, ::qs]
        q = q_criterion(uq)
        q[solid_full] = 0.0
    q_proj = q[: (nz_out // qs or None) if nz_out else Z].max(axis=0)
    vmax = max(np.percentile(q_proj, 99.5), 1e-12)
    image = compose_panels([
        panel(speed_k, solid_k, colorscale_rainbow, speed_k.max()),
        panel(speed_y, solid_y, colorscale_rainbow, speed_y.max()),
        panel(np.clip(q_proj, 0, vmax), np.zeros(q_proj.shape, bool),
              colorscale_iron, vmax)])
    write_png(out_path, image, title)

    # companion 3-D frame: raytraced flags + Q isosurface + streamlines
    # (reference raytrace/streamline kernels, kernel.cpp:2642-3200) —
    # rendered from the (possibly decimated) Q-grid arrays so shapes agree
    try:
        q_pos = q[~solid_full]
        thr = float(np.percentile(q_pos[q_pos > 0], 97.0)) if (q_pos > 0).any() else None
        out_3d = out_path.with_name(out_path.stem + "_3d.png")
        if on_device:
            # full-resolution march on the device; solid_j / u_j are
            # already trimmed to nz_out above
            from .render_device import q_criterion_device, render_scene_device

            render_scene_device(
                solid_j, u_j, out_3d,
                q=torch.where(solid_j, torch.zeros((), device=solid_j.device),
                              q_criterion_device(u_j))
                if thr is not None else None,
                q_threshold=thr, title=title, u_factor=1.0)
        else:
            from .render import render_scene

            nzq = (max(1, nz_out // qs) if nz_out else None)
            render_scene(
                solid_full[:nzq], uq[:, :nzq] * u_factor, out_3d,
                q=q[:nzq] if thr is not None else None,
                q_threshold=thr, title=title, u_factor=1.0)
    except Exception as e:   # rendering must never kill a solver run
        print(f"[snapshots] 3-D render skipped: {e}")
    return out_path


def write_frame(state: LBMState, out_path: Path, *, nz_out: int = 0,
                title: str = "", fov: float = 70.0) -> Path:
    """One perspective video frame (no VTK dump): raytraced geometry +
    Q isosurface + streamlines through the pinhole camera.

    The deck's `frame_output` stride drives these — the analog of the
    reference's per-event PNG frame writes (setup.cpp:4843-4861, in-device
    graphics kernels) — with zero-padded numbering so the set is
    ffmpeg-ready (`ffmpeg -pattern_type glob -i 'frames/*.png' ...`)."""
    from .render import Camera, render_scene

    if _render_on_device(state.u):
        from .render_device import (
            percentile, q_criterion_device, render_scene_device,
        )

        u_j = state.u
        flags_j = state.flags
        if nz_out:
            u_j = u_j[:, :nz_out]
            flags_j = flags_j[:nz_out]
        solid_j = (flags_j & TYPE_S) != 0
        q_j = torch.where(solid_j, torch.zeros((), device=solid_j.device),
                          q_criterion_device(u_j))
        frac = float((q_j > 0).to(torch.float32).mean())
        thr = None
        if frac > 0:
            # 97th percentile of the positive part == (1 - 0.03*frac)
            # quantile of the full field (device-friendly formulation)
            thr = percentile(q_j, 100.0 * (1.0 - 0.03 * frac))
        return render_scene_device(
            solid_j, u_j, out_path, q=q_j if thr is not None else None,
            q_threshold=thr, cam=Camera(fov=fov), title=title)

    u = _host(state.u)
    flags = _host(state.flags)
    if nz_out:
        u = u[:, :nz_out]
        flags = flags[:nz_out]
    # decimate BEFORE the Q stencil: q_criterion is 18 full-grid rolls in
    # f64 — minutes per frame at 100M cells, while the frame itself renders
    # from <= 8M cells anyway (render_scene would re-decimate)
    cells = int(np.prod(flags.shape))
    if cells > Q_MAX_CELLS:
        s = int(np.ceil((cells / Q_MAX_CELLS) ** (1.0 / 3.0)))
        u = u[:, ::s, ::s, ::s]
        flags = flags[::s, ::s, ::s]
    solid = (flags & TYPE_S) != 0
    q = q_criterion(u)
    q[solid] = 0.0
    q_pos = q[q > 0]
    thr = float(np.percentile(q_pos, 97.0)) if q_pos.size else None
    return render_scene(
        solid, u, out_path, q=q if thr is not None else None,
        q_threshold=thr, cam=Camera(fov=fov), title=title)


def _decode_ddf_np(raw) -> np.ndarray:
    """Stored DDFs -> fp32, inferring the storage codec from the dtype
    (f32/bf16 pass through, float16 is the FP16S range shift, uint16 is
    the FP16C software format — lbm/state.py codecs).  Takes a tensor or a
    numpy array (numpy's uint16 is fp16c, as in the JAX package)."""
    if isinstance(raw, torch.Tensor):
        if raw.dtype == torch.uint16:
            return decode_fp16c(raw.cpu()).numpy()
        f = raw.cpu().to(torch.float32).numpy()
        return f * np.float32(1.0 / 32768.0) if raw.dtype == torch.float16 else f
    raw = np.asarray(raw)
    if raw.dtype == np.uint16:            # FP16C value-space codec
        return decode_fp16c(torch.from_numpy(raw.view(np.int16)).view(
            torch.uint16)).numpy()
    f = raw.astype(np.float32)
    if raw.dtype == np.float16:           # FP16S-style range shift
        f = f * (1.0 / 32768.0)
    return f


def solid_boundary_force_field(state: LBMState) -> np.ndarray:
    """Per-cell momentum-exchange force on solid cells, (3, Z, Y, X) in
    lattice units — the reference's FORCE_FIELD extension
    (update_force_field, kernel.cpp:2031-2130): every fluid-solid link
    deposits the halfway-bounce-back transfer 2 c_i (f_i + w_i) onto the
    solid cell, giving the colored per-boundary force the flags renderer
    draws (kernel.cpp:2698-2709) and per-object force sums."""
    from ..lbm.lattice import C19, W19

    solid = (_host(state.flags) & TYPE_S) != 0
    f = _decode_ddf_np(state.fi)
    F = np.zeros((3, *solid.shape), np.float64)
    for d in range(1, 19):
        cx, cy, cz = (int(v) for v in C19[d])
        # fluid cell at x with solid neighbor at x + c_d: the post-collision
        # population f_d heads into the wall and bounces, depositing 2 c_d f_d
        nbr_solid = np.roll(solid, shift=(-cz, -cy, -cx), axis=(0, 1, 2))
        link = (~solid) & nbr_solid
        if not link.any():
            continue
        mom = np.where(link, f[d] + float(W19[d]), 0.0)   # undo the DDF shift
        # scatter onto the receiving solid cell at x + c_d
        onto = np.roll(mom, shift=(cz, cy, cx), axis=(0, 1, 2))
        for c, comp in enumerate((cx, cy, cz)):
            if comp:
                F[c] += 2.0 * comp * onto
    F[:, ~solid] = 0.0
    return F


def solid_boundary_force(state: LBMState) -> np.ndarray:
    """Total momentum-exchange force on solid cells, (3,) lattice units.

    Same physics as solid_boundary_force_field but accumulated as scalars
    per direction — the field variant materializes a (3, Z, Y, X) float64
    array (+ per-direction roll temporaries), multi-GB at production grids,
    which a caller wanting only the total must not pay."""
    from ..lbm.lattice import C19, W19

    solid = (_host(state.flags) & TYPE_S) != 0
    f = _decode_ddf_np(state.fi)
    total = np.zeros(3, np.float64)
    for d in range(1, 19):
        cx, cy, cz = (int(v) for v in C19[d])
        nbr_solid = np.roll(solid, shift=(-cz, -cy, -cx), axis=(0, 1, 2))
        link = (~solid) & nbr_solid
        if not link.any():
            continue
        # total over links; the scatter roll in the field variant conserves
        # the sum, so it drops out of the total (accumulate in f64 like it)
        s = 2.0 * float((f[d][link] + float(W19[d])).sum(dtype=np.float64))
        for c, comp in enumerate((cx, cy, cz)):
            if comp:
                total[c] += comp * s
    return total
