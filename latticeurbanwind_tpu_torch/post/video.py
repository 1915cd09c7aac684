"""luwvideo — render a VTK timestep series into an ffmpeg-ready frame set.

Counterpart of `latticeurbanwind_tpu/post/video.py` (host numpy): the
headless equivalent of the reference streamcenter viewer's recording
(gui/streamcenter/ViewerWidget.cpp) with its FRUC frame interpolation
(gui/src/NvidiaFrucRuntime.cpp).  It walks a `<base>-<step>.vtk` series,
renders one PNG per step through a view mode — `slice` / `mip` (the
horizontal speed, rainbow over the series' pinned range, through
`io/figure.py`; no colour bar, the title in the PNG's text chunk) or `3d`
/ `volume` (`run/render.py::render_scene`) — and can insert N frames
between steps, blending the FIELDS linearly before rendering.

Frames are written as `frame_%05d.png`, ready for
`ffmpeg -framerate 12 -i frame_%05d.png out.mp4`.

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwvideo RESULTS/vtk/<case>_raw_u-000000200.vtk
"""

from __future__ import annotations

import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..io.figure import Figure, panel_size
from ..io.progress import ProgressEmitter
from ..io.vtk import read_structured_points
from ..run.render import Camera, render_scene

MAX_RENDER_CELLS = 2_000_000        # same interactive budget as the studio


def discover_series(vtk_path: Path) -> List[Path]:
    """All files sharing `<base>-<step>.vtk` with vtk_path, step-sorted
    (the studio's api_series contract)."""
    m = re.match(r"(.+)-(\d+)$", vtk_path.stem)
    if not m:
        return [vtk_path]
    base = m.group(1)
    found = []
    for f in vtk_path.parent.glob(f"{base}-*.vtk"):
        mm = re.match(r"(.+)-(\d+)$", f.stem)
        if mm and mm.group(1) == base:
            found.append((int(mm.group(2)), f))
    return [f for _, f in sorted(found)]


def _decimate(fields: Dict[str, np.ndarray]) -> tuple:
    """(fields, stride): interactive-budget subsampling.  Callers must
    rescale any full-resolution layer index by the returned stride."""
    spatial = next(iter(fields.values())).shape[-3:]
    cells = int(np.prod(spatial))
    if cells <= MAX_RENDER_CELLS:
        return fields, 1
    s = int(np.ceil((cells / MAX_RENDER_CELLS) ** (1.0 / 3.0)))
    sl = (..., slice(None, None, s), slice(None, None, s),
          slice(None, None, s))
    return {k: v[sl] for k, v in fields.items()}, s


def lerp_fields(fa: Dict[str, np.ndarray], fb: Dict[str, np.ndarray],
                t: float) -> Dict[str, np.ndarray]:
    """Linear field blend for intermediate frames (FRUC analog — field
    space, not bitmap space)."""
    out = {}
    for k in fa:
        if k in fb and fb[k].shape == fa[k].shape:
            out[k] = (fa[k].astype(np.float32) * (1.0 - t)
                      + fb[k].astype(np.float32) * t)
        else:
            out[k] = fa[k]
    return out


def render_frame(fields: Dict[str, np.ndarray], out_path: Path, *,
                 mode: str = "slice", z: int = 0, az: float = 225.0,
                 el: float = 35.0, zoom: float = 1.0, color: str = "u",
                 gain: float = 1.0, title: str = "",
                 vmax: Optional[float] = None) -> Path:
    """One frame through the chosen view mode.  `vmax` pins the color
    scale across the series so playback doesn't flicker."""
    vec = next((v for v in fields.values() if v.ndim == 4), None)
    fluid = fields.get("fluid")
    if mode in ("3d", "volume"):
        if fluid is not None:
            solid = fluid < 0.5
        elif vec is not None:
            solid = np.abs(vec).sum(axis=0) == 0.0
            solid[-1] = False
        else:
            raise ValueError(f"{mode} mode needs a vector or fluid field")
        volume = None
        t_avg = 0.0
        scale = None
        if mode == "volume":
            if color == "u" and vec is not None:
                scalar = np.sqrt((vec.astype(np.float32) ** 2).sum(axis=0))
            else:
                key = next((k for k in fields
                            if k.split("_")[0].lower() == color.lower()
                            and fields[k].ndim == 3), None)
                if key is None:
                    raise ValueError(f"no {color} field for volume coloring")
                scalar = fields[key].astype(np.float32)
                if color == "T":
                    t_avg = float(scalar.mean())
            volume = (scalar, color)
            if vmax is not None and color == "u":
                scale = 1.0 / max(vmax, 1e-9)
        return render_scene(
            solid, vec, out_path, cam=Camera(azimuth=az, elevation=el,
                                             zoom=zoom, width=820,
                                             height=600),
            streamlines=(mode == "3d"), volume=volume, t_avg=t_avg,
            opacity_gain=gain, field_scale=scale, title=title)

    if vec is None:
        raise ValueError("slice/mip modes need a vector field")
    speed = np.sqrt((vec.astype(np.float32) ** 2).sum(axis=0))
    img = speed.max(axis=0) if mode == "mip" else speed[
        min(max(z, 0), speed.shape[0] - 1)]
    fig = Figure(1, 1, panel_size(img.shape[1], img.shape[0], 720), title=title)
    fig.panels[0].image(img, scale="rainbow", vmin=0.0, vmax=vmax)
    return fig.save(out_path)


def export_frames(first_vtk: Path, out_dir: Path, *, mode: str = "slice",
                  interp: int = 0, z: int = 0, az: float = 225.0,
                  el: float = 35.0, zoom: float = 1.0, color: str = "u",
                  gain: float = 1.0,
                  progress: Optional[ProgressEmitter] = None) -> List[Path]:
    """Render the whole series (plus `interp` blended frames between
    consecutive steps) to out_dir/frame_%05d.png."""
    series = discover_series(first_vtk)
    if not series:
        raise FileNotFoundError(f"no series at {first_vtk}")
    out_dir.mkdir(parents=True, exist_ok=True)
    total = len(series) + max(0, interp) * max(0, len(series) - 1)

    # pin the color range over the whole series (first + last sample)
    def speed_max(path: Path) -> float:
        _, f = read_structured_points(path)
        vec = next((v for v in f.values() if v.ndim == 4), None)
        if vec is None:
            return 0.0
        return float(np.sqrt((vec.astype(np.float32) ** 2).sum(0)).max())

    vmax = max(speed_max(series[0]), speed_max(series[-1])) or None

    written: List[Path] = []
    prev_fields = None
    n = 0
    for i, path in enumerate(series):
        _, fields = read_structured_points(path)
        fields, stride = _decimate(fields)
        zi = z // stride          # --z is a full-resolution layer index
        if prev_fields is not None and interp > 0:
            for j in range(1, interp + 1):
                t = j / (interp + 1)
                blended = lerp_fields(prev_fields, fields, t)
                out = out_dir / f"frame_{n:05d}.png"
                written.append(render_frame(
                    blended, out, mode=mode, z=zi, az=az, el=el, zoom=zoom,
                    color=color, gain=gain, vmax=vmax,
                    title=f"{path.stem} (interp {t:.2f})"))
                n += 1
                if progress:
                    progress.emit("render frames", path.name,
                                  len(written), total)
        out = out_dir / f"frame_{n:05d}.png"
        written.append(render_frame(
            fields, out, mode=mode, z=zi, az=az, el=el, zoom=zoom,
            color=color, gain=gain, vmax=vmax, title=path.stem))
        n += 1
        if progress:
            progress.emit("render frames", path.name,
                          len(written), total)
        prev_fields = fields
    return written


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="luwvideo",
        description="Render a VTK timestep series to an ffmpeg-ready PNG "
                    "frame set with optional interpolated in-between frames "
                    "(the reference streamcenter recording + FRUC analog).")
    parser.add_argument("vtk", help="any VTK of the series (its "
                        "<base>-<step>.vtk siblings are discovered)")
    parser.add_argument("--out-dir", help="frame directory (default "
                        "<vtk dir>/video_<base>)")
    parser.add_argument("--mode", default="slice",
                        choices=["slice", "mip", "3d", "volume"])
    parser.add_argument("--interp", type=int, default=0, metavar="N",
                        help="insert N field-blended frames between steps")
    parser.add_argument("--z", type=int, default=0, help="slice layer")
    parser.add_argument("--az", type=float, default=225.0)
    parser.add_argument("--el", type=float, default=35.0)
    parser.add_argument("--zoom", type=float, default=1.0)
    parser.add_argument("--color", default="u", choices=["u", "rho", "T"],
                        help="volume-mode field coloring")
    parser.add_argument("--gain", type=float, default=1.0,
                        help="volume-mode opacity gain")
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    vtk = Path(args.vtk).expanduser().resolve()
    if not vtk.exists():
        print(f"luwvideo: ERROR: {vtk} not found")
        return 1
    base = re.sub(r"-\d+$", "", vtk.stem)
    out_dir = (Path(args.out_dir).expanduser().resolve() if args.out_dir
               else vtk.parent / f"video_{base}")
    progress = ProgressEmitter("video")
    try:
        frames = export_frames(
            vtk, out_dir, mode=args.mode, interp=args.interp, z=args.z,
            az=args.az, el=args.el, zoom=args.zoom, color=args.color,
            gain=args.gain, progress=progress)
    except (FileNotFoundError, ValueError) as e:
        print(f"luwvideo: ERROR: {e}")
        return 1
    print(f"luwvideo: wrote {len(frames)} frames -> {out_dir}")
    print(f"luwvideo: ffmpeg -framerate 12 -i {out_dir}/frame_%05d.png "
          f"-pix_fmt yuv420p {base}.mp4")
    return 0


if __name__ == "__main__":
    sys.exit(main())
