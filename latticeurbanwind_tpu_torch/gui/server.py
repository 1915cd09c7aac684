"""LUW Studio server of the port: deck editor + pipeline runner + results viewer.

Counterpart of `latticeurbanwind_tpu/gui/server.py`, with the same routes,
the same JSON answers and the same page (this package's own `app.html`):

  * project tree + schema-driven deck editor synced to canonical raw text
    (the port's `deck/schema.py`);
  * pipeline orchestration with console forwarding and `[[LUW_PROGRESS]]`
    protocol parsing: a job is one command of the port's dispatcher
    (`python -m latticeurbanwind_tpu_torch.cli.dispatch <cmd> ...`) in a
    child process, so `runluw`, `makeluw` and `luwvox` run on the card
    (their `--device` defaults to cuda) unless the job's own arguments say
    `--device cpu`; a child that fails shows its exit code and is never
    rerun elsewhere;
  * result viewing: VTK slices, MIPs, the 3-D and volume views (the host
    renderer `run/render.py`), LOD bricks (`gui/stream.py`) and the panels;
  * startup diagnostics via /api/env: torch and CUDA, the visible cards,
    whether the kernels' library for the current sources is built.

The JAX studio draws its PNG panels with matplotlib, which the card's
machine does not have: here they are drawn through `io/figure.py` (the
same panels, no colour bars or axis text, the titles in the PNG's `tEXt`
chunk).  Stdlib only (ThreadingHTTPServer); binds 127.0.0.1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from ..cli.dispatch import COMMANDS

APP_HTML = Path(__file__).with_name("app.html")
PROGRESS_TAG = "[[LUW_PROGRESS]]"
# the directory the port's package sits in: a job's child imports the same
# package (and so loads the kernels' library from the same build directory)
PKG_ROOT = Path(__file__).resolve().parents[2]

# interactive renders decimate to this many cells: parsing + marching a
# production avg VTK (100M+ cells) per playback frame is what a dedicated
# large-volume viewer exists to avoid; a 2M-cell preview keeps frames
# sub-second
MAX_RENDER_CELLS = 2_000_000

# per-patch colours of the boundary panel (matplotlib's default cycle)
PATCH_RGB = ((0.12, 0.47, 0.71), (1.0, 0.5, 0.05), (0.17, 0.63, 0.17),
             (0.84, 0.15, 0.16), (0.58, 0.4, 0.74), (0.55, 0.34, 0.29),
             (0.89, 0.47, 0.76), (0.5, 0.5, 0.5))


class _VtkCache:
    """Parsed-VTK LRU keyed by (path, mtime_ns, size).

    Playback re-requests the same files once per slider tick; the parse of a
    multi-GB legacy binary VTK dominates the frame time, so cache the
    (meta, fields) tuples and invalidate on file change."""

    def __init__(self, capacity: int = 6):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: Dict = {}     # key -> (order, meta, fields)
        self._tick = 0

    def get(self, path: Path):
        from ..io.vtk import read_structured_points

        st = path.stat()
        key = (str(path), st.st_mtime_ns, st.st_size)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._tick += 1
                self._entries[key] = (self._tick, hit[1], hit[2])
                return hit[1], hit[2]
        meta, fields = read_structured_points(path)
        with self._lock:
            self._tick += 1
            self._entries[key] = (self._tick, meta, fields)
            stale = [k for k in self._entries if k[0] == str(path) and k != key]
            for k in stale:
                del self._entries[k]
            while len(self._entries) > self.capacity:
                oldest = min(self._entries, key=lambda k: self._entries[k][0])
                del self._entries[oldest]
        return meta, fields


def _decimate(arr: np.ndarray, in_plane_only: bool = False):
    """Stride-subsample a (Z,Y,X) or (3,Z,Y,X) field to <= MAX_RENDER_CELLS.

    Returns (array, stride).  `in_plane_only` keeps the z axis intact so
    slice indices stay valid."""
    spatial = arr.shape[-3:]
    cells = int(np.prod(spatial))
    if cells <= MAX_RENDER_CELLS:
        return arr, 1
    if in_plane_only:
        s = int(np.ceil(np.sqrt(spatial[1] * spatial[2]
                                / (MAX_RENDER_CELLS / spatial[0]))))
        sl = (..., slice(None), slice(None, None, s), slice(None, None, s))
    else:
        s = int(np.ceil((cells / MAX_RENDER_CELLS) ** (1.0 / 3.0)))
        sl = (..., slice(None, None, s), slice(None, None, s),
              slice(None, None, s))
    return arr[sl], s


# commands the Run panel may launch: the port dispatcher's, but the studio
ALLOWED_COMMANDS = tuple(c for c in COMMANDS if c != "luwstudio")


class Job:
    """One dispatcher command in a child process, its output pumped into
    `lines` (progress lines into `progress`) by a thread."""

    _next_id = 1
    _lock = threading.Lock()

    def __init__(self, argv: List[str], cwd: Path):
        with Job._lock:
            self.id = Job._next_id
            Job._next_id += 1
        self.argv = argv
        self.lines: List[str] = []
        self.progress: Optional[dict] = None
        self.rc: Optional[int] = None
        self.started = time.time()
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, LUW_PROGRESS_MODE="gui", PYTHONUNBUFFERED="1",
                   PYTHONPATH=str(PKG_ROOT) + (os.pathsep + path if path else ""))
        self.proc = subprocess.Popen(
            argv, cwd=str(cwd), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, errors="replace")
        self._pump_thread = threading.Thread(target=self._pump, daemon=True)
        self._pump_thread.start()

    def _pump(self):
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            if PROGRESS_TAG in line:
                try:
                    self.progress = json.loads(
                        line.split(PROGRESS_TAG, 1)[1].strip())
                except json.JSONDecodeError:
                    pass
                continue
            self.lines.append(line)
        self.proc.stdout.close()
        self.rc = self.proc.wait()

    def state(self, start: int = 0) -> dict:
        return {
            "id": self.id, "argv": self.argv, "from": start,
            "lines": self.lines[start:], "n_lines": len(self.lines),
            "progress": self.progress, "done": self.rc is not None,
            "rc": self.rc, "elapsed": round(time.time() - self.started, 1),
        }

    def stop(self, timeout: float = 10.0) -> None:
        """End the child if it still runs (terminate, then kill) and wait
        for it and for the pump."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._pump_thread.join(timeout)


def _speed(vec: np.ndarray) -> np.ndarray:
    return np.sqrt((np.asarray(vec, np.float32) ** 2).sum(axis=0))


class Studio:
    def __init__(self, root: Path):
        from .stream import PyramidCache

        self.root = root.resolve()
        self.jobs: Dict[int, Job] = {}
        self.vtk_cache = _VtkCache()
        self.pyramids = PyramidCache()

    def close(self) -> None:
        """Stop every job still running."""
        for job in list(self.jobs.values()):
            job.stop()

    # ---------------- path safety ----------------
    def resolve(self, raw: str) -> Path:
        p = (self.root / raw).resolve() if not raw.startswith("/") else Path(raw).resolve()
        if p != self.root and self.root not in p.parents:
            raise PermissionError(f"path escapes studio root: {raw}")
        return p

    # ---------------- API handlers ----------------
    def api_tree(self, q) -> dict:
        sub = self.resolve(q.get("path", [""])[0])
        items = []
        if sub.is_dir():
            for child in sorted(sub.iterdir(),
                                key=lambda c: (c.is_file(), c.name.lower())):
                if child.name.startswith("."):
                    continue
                items.append({
                    "name": child.name,
                    "path": str(child.relative_to(self.root)),
                    "dir": child.is_dir(),
                    "size": child.stat().st_size if child.is_file() else 0,
                })
        return {"root": str(self.root), "path": str(sub.relative_to(self.root))
                if sub != self.root else "", "items": items}

    def api_schema(self, q) -> dict:
        from ..deck.schema import FIELDS, MODE_BITS, SECTIONS

        mode = q.get("mode", ["luw"])[0]
        bit = MODE_BITS.get(mode, 1)
        sections = []
        for s in SECTIONS:
            fields = [{
                "key": f.key, "kind": f.kind, "label": f.label or f.key,
                "help": f.help, "enum": list(f.enum_values),
            } for f in FIELDS if f.section == s.id and (f.modes & bit)]
            if fields:
                sections.append({"id": s.id, "title": s.title,
                                 "help": s.description, "fields": fields})
        return {"mode": mode, "sections": sections}

    def api_deck_get(self, q) -> dict:
        from ..deck import load_deck

        path = self.resolve(q["path"][0])
        deck = load_deck(path)
        return {
            "path": q["path"][0],
            "mode": path.suffix.lstrip("."),
            "raw": path.read_text(),
            "values": {k: str(v) for k, v in deck.to_dict().items()},
        }

    def api_deck_post(self, body: dict) -> dict:
        from ..deck import load_deck

        path = self.resolve(body["path"])
        if "raw" in body:
            path.write_text(body["raw"])
        deck = load_deck(path)
        for key, value in (body.get("values") or {}).items():
            deck.set_text(key, str(value))
        deck.save()
        return self.api_deck_get({"path": [body["path"]]})

    def api_run(self, body: dict) -> dict:
        cmd = body.get("cmd", "")
        if cmd not in ALLOWED_COMMANDS:
            raise ValueError(f"unknown command {cmd!r}")
        args = [str(a) for a in (body.get("args") or [])]
        cwd = self.resolve(body.get("cwd", ""))
        argv = [sys.executable, "-m", "latticeurbanwind_tpu_torch.cli.dispatch",
                cmd, *args]
        job = Job(argv, cwd if cwd.is_dir() else cwd.parent)
        self.jobs[job.id] = job
        return job.state()

    def api_job(self, q) -> dict:
        job = self.jobs[int(q["id"][0])]
        return job.state(int(q.get("from", ["0"])[0]))

    def api_results(self, q) -> dict:
        base = self.resolve(q.get("path", [""])[0])
        out = {"vtks": [], "images": [], "csvs": []}
        for sub in ("RESULTS/vtk", "RESULTS", "RESULTS/sections",
                    "RESULTS/figures", "proj_temp", "proj_temp/snapshots",
                    "RESULTS/tke_viz", ""):
            d = base / sub if sub else base
            if not d.is_dir():
                continue
            for f in sorted(d.iterdir()):
                rel = str(f.relative_to(self.root))
                if f.suffix == ".vtk":
                    out["vtks"].append(rel)
                elif f.suffix in (".png", ".jpg"):
                    out["images"].append(rel)
                elif f.suffix == ".csv":
                    out["csvs"].append(rel)
        for k in out:
            out[k] = sorted(set(out[k]))
        return out

    def api_boundary(self, q) -> bytes:
        """SurfData boundary-CSV preview PNG: per-face samples coloured by
        |u| in plan view (X, Y) and elevation (X, Z), and the faces (X, Z)
        coloured by patch, with per-patch counts and speed statistics in
        the title."""
        from ..bc.samples import read_surfdata_csv
        from ..io.figure import Figure, color_limits
        from ..run.fieldvis import colorscale_rainbow

        path = self.resolve(q["path"][0])
        samples = read_surfdata_csv(path)
        x, y, z = samples.p.T
        speed = np.sqrt((samples.u ** 2).sum(axis=1))
        patch = (samples.patch if samples.patch is not None
                 else np.full(len(x), -1))

        lo, hi = color_limits(speed)
        rgb = colorscale_rainbow((speed - lo) / (hi - lo))
        names = {0: "bottom", 1: "top", 2: "south", 3: "north",
                 4: "west", 5: "east", -1: "all", -999: "n/a"}
        stats = []
        for p in sorted(set(patch.tolist())):
            stats.append(f"{names.get(p, p)}: {int((patch == p).sum())}")
        fig = Figure(1, 3, (360, 300), title=(
            f"{path.name} — {len(x)} samples, |u| "
            f"{speed.min():.2f}..{speed.max():.2f} m/s | " + ", ".join(stats)))

        def span(v):
            return (float(v.min()), float(v.max()) if v.max() > v.min()
                    else float(v.min()) + 1.0)

        plan, elev, faces = fig.panels
        plan.limits(span(x), span(y)).markers(x, y, rgb, size=1)
        plan.title = "plan view (X, Y)"
        elev.limits(span(x), span(z)).markers(x, z, rgb, size=1)
        elev.title = "elevation (X, Z)"
        faces.limits(span(x), span(z))
        for i, p in enumerate(sorted(set(patch.tolist()))):
            m = patch == p
            faces.markers(x[m], z[m], PATCH_RGB[i % len(PATCH_RGB)], size=1)
        faces.title = "faces (X, Z) by patch"
        return fig.to_png()

    def api_series(self, q) -> dict:
        """Timestep series for a VTK: all files sharing its `<base>-<t>.vtk`
        stem, sorted by step — drives the playback slider."""
        import re

        path = self.resolve(q["path"][0])
        m = re.match(r"(.+)-(\d+)$", path.stem)
        if not m:
            return {"steps": [], "files": []}
        base = m.group(1)
        steps, files = [], []
        for f in sorted(path.parent.glob(f"{base}-*.vtk")):
            mm = re.match(r"(.+)-(\d+)$", f.stem)
            if mm and mm.group(1) == base:
                steps.append(int(mm.group(2)))
                files.append(str(f.relative_to(self.root)))
        order = sorted(range(len(steps)), key=lambda i: steps[i])
        return {"steps": [steps[i] for i in order],
                "files": [files[i] for i in order]}

    def api_render(self, q) -> bytes:
        """VTK render -> PNG.

        mode=slice (default): one z layer, arrows over a vector field's
        speed.  mode=mip: maximum-intensity projection along z/y/x.
        mode=3d: raytraced geometry + Q isosurface + streamlines through
        the orthographic camera (run/render.py; az/el/zoom parameters).
        mode=volume: the volumetric raycast of |u| / rho / T (`color=`),
        opacity `gain=`, optional embedded coloured slice plane
        `splane=z:12`, all composited over the raytraced geometry.
        field=Q: virtual Q-criterion field derived from the velocity
        (run/snapshots.q_criterion).

        Parsed VTKs are served from an mtime-keyed LRU and fields above
        MAX_RENDER_CELLS are stride-decimated, so playback over production
        volumes stays interactive.  All of it is host numpy.
        """
        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        name = q.get("field", [None])[0]
        mode = q.get("mode", ["slice"])[0]
        axis = {"z": 0, "y": 1, "x": 2}.get(q.get("axis", ["z"])[0], 0)
        z = int(q.get("z", ["0"])[0])
        stride = 1
        if q.get("full", ["0"])[0] != "1":
            dec = {k: _decimate(v, in_plane_only=(mode == "slice"))
                   for k, v in fields.items()}
            stride = max((s for _, s in dec.values()), default=1)
            fields = {k: v for k, (v, _) in dec.items()}

        if mode in ("3d", "volume"):
            import tempfile

            from ..run.render import Camera, render_scene
            from ..run.snapshots import q_criterion

            vec = next((v for v in fields.values() if v.ndim == 4), None)
            fluid = fields.get("fluid")
            if fluid is not None:
                solid = fluid < 0.5
            elif vec is not None:
                solid = (np.abs(vec).sum(axis=0) == 0.0)
                solid[-1] = False      # open top even if still
            else:
                raise ValueError("3d view needs a vector or fluid field")
            qf = thr = None
            if (mode == "3d" and vec is not None
                    and q.get("q", ["1"])[0] != "0"):
                qf = q_criterion(vec.astype(np.float64)).astype(np.float32)
                qf[solid] = 0.0
                pos = qf[qf > 0]
                if pos.size:
                    thr = float(np.percentile(pos, 97.0))
            volume = slice_spec = None
            t_avg = 0.0
            if mode == "volume":
                cmode = q.get("color", ["u"])[0]
                scalar = None
                if cmode == "u" and vec is not None:
                    scalar = _speed(vec)
                elif cmode in ("rho", "T"):
                    key = next((k for k in fields
                                if k.split("_")[0].lower() == cmode.lower()
                                and fields[k].ndim == 3), None)
                    if key is None:
                        raise ValueError(f"no {cmode} field in this VTK")
                    scalar = fields[key].astype(np.float32)
                    if cmode == "T":
                        t_avg = float(scalar[~solid].mean()
                                      if (~solid).any() else scalar.mean())
                else:
                    raise ValueError("volume view needs a vector field "
                                     "(color=u) or a rho/T scalar")
                volume = (scalar, cmode)
                spl = q.get("splane", [""])[0]
                if spl:
                    ax_s, _, idx_s = spl.partition(":")
                    axis_n = {"z": 0, "y": 1, "x": 2}.get(ax_s, 0)
                    # the UI slider indexes the FULL-resolution grid; the
                    # fields above were already stride-decimated here, so
                    # rescale (render_scene only rescales when IT decimates)
                    slice_spec = (axis_n, int(idx_s or 0) // stride,
                                  scalar, cmode)
            cam = Camera(
                azimuth=float(q.get("az", ["225"])[0]),
                elevation=float(q.get("el", ["35"])[0]),
                zoom=float(q.get("zoom", ["1.0"])[0]),
                width=820, height=600)
            with tempfile.TemporaryDirectory() as td:
                out = render_scene(
                    solid, vec, Path(td) / "f.png", q=qf, q_threshold=thr,
                    cam=cam, title=path.name + (f" [decimated x{stride}]" if stride > 1 else ""),
                    streamlines=(mode == "3d"
                                 and q.get("sl", ["1"])[0] != "0"),
                    volume=volume, slice_spec=slice_spec, t_avg=t_avg,
                    opacity_gain=float(q.get("gain", ["1.0"])[0]))
                return out.read_bytes()

        if name == "Q":
            from ..run.snapshots import q_criterion

            vec = next((v for v in fields.values() if v.ndim == 4), None)
            if vec is None:
                raise ValueError("Q-criterion needs a vector field")
            arr = q_criterion(vec.astype(np.float64)).astype(np.float32)
            arr = np.clip(arr, 0.0, None)
        elif name is None or name not in fields:
            name = next(iter(fields))
            arr = fields[name]
        else:
            arr = fields[name]

        from ..io.figure import Figure, panel_size

        dtag = f" [decimated x{stride}]" if stride > 1 else ""
        scale = "iron" if name == "Q" else "rainbow"
        arrows = None
        if mode == "mip":
            mag = _speed(arr) if arr.ndim == 4 else arr
            img = mag.max(axis=axis)
            label = f"max |{name}| along {'zyx'[axis]}"
            title = f"{path.name} — {name} MIP/{'zyx'[axis]}{dtag}"
        elif arr.ndim == 4:       # vector slice: speed + arrows
            z = min(max(z, 0), arr.shape[1] - 1)
            img = _speed(arr[:, z])
            st = max(1, max(img.shape) // 24)
            xs, ys = np.meshgrid(np.arange(0, arr.shape[3], st),
                                 np.arange(0, arr.shape[2], st))
            arrows = (xs + 0.5, ys + 0.5, arr[0, z, ::st, ::st],
                      arr[1, z, ::st, ::st])
            label = f"|{name}|"
            title = f"{path.name} — {name} @ z={z}{dtag}"
        else:
            z = min(max(z, 0), arr.shape[0] - 1)
            img = arr[z]
            label = name
            title = f"{path.name} — {name} @ z={z}{dtag}"
        fig = Figure(1, 1, panel_size(img.shape[1], img.shape[0], 560),
                     title=title)
        ax = fig.panels[0]
        ax.image(img, scale=scale)
        if arrows is not None:
            ax.arrows(*arrows)
        ax.title = label
        return fig.to_png()

    # ------------- progressive volume streaming ----
    def _pyramid(self, q):
        path = self.resolve(q["path"][0])
        field = q.get("field", ["u"])[0]
        st = path.stat()
        return self.pyramids.get(
            path, st, field, lambda: self.vtk_cache.get(path)[1])

    def api_volinfo(self, q) -> dict:
        """LOD/brick layout of one VTK field (gui/stream.py) — the client's
        entry point for progressive streaming."""
        path = self.resolve(q["path"][0])
        meta, _ = self.vtk_cache.get(path)
        info = self._pyramid(q).info()
        info["spacing"] = meta.get("spacing")
        info["origin"] = meta.get("origin")
        return info

    def api_brick(self, q):
        """One raw float16 brick: body is little-endian float16, the
        X-Brick-Shape header carries its (dz,dy,dx).

        `path2` + `alpha` serve a temporally interpolated brick — the
        playback sub-frame source.  Default interpolation is
        motion-compensated: per-brick phase-correlation displacement +
        advect-and-blend (gui/stream.warp_blend), which keeps advecting
        structures single and moving instead of cross-fade ghosting;
        `interp=lerp` requests the plain volume-space cross-fade."""
        coords = (int(q["level"][0]), int(q.get("i", ["0"])[0]),
                  int(q.get("j", ["0"])[0]), int(q.get("k", ["0"])[0]))
        pyr = self._pyramid(q)
        tile = pyr.brick(*coords)
        if "path2" in q:
            alpha = min(1.0, max(0.0, float(q.get("alpha", ["0.5"])[0])))
            q2 = dict(q)
            q2["path"] = q["path2"]
            pyr2 = self._pyramid(q2)
            t2 = pyr2.brick(*coords)
            if t2.shape != tile.shape:
                raise ValueError(
                    f"interpolation frames disagree on brick shape "
                    f"{tile.shape} vs {t2.shape} — different grids?")
            mode = q.get("interp", ["warp"])[0]
            if mode == "lerp":
                tile = ((1.0 - alpha) * tile.astype(np.float32)
                        + alpha * t2.astype(np.float32)).astype(np.float16)
            else:
                from .stream import warped_brick

                level = coords[0]
                tile = warped_brick(
                    pyr.levels[level], pyr2.levels[level], pyr.brick_size,
                    coords[1:], alpha).astype(np.float16)
        shape = ",".join(str(s) for s in tile.shape)
        return tile.tobytes(), {"X-Brick-Shape": shape}

    def api_vtk_info(self, q) -> dict:
        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        return {
            "fields": {k: list(v.shape) for k, v in fields.items()},
            "spacing": meta.get("spacing"), "origin": meta.get("origin"),
        }

    def api_pick(self, q) -> dict:
        """Cell picking: given full-resolution grid indices — a column
        (axis + 2 in-plane indices) or one cell (z,y,x) — return world
        coordinates and every field's value there; columns also report the
        |column| profile and its argmax depth (what the stream viewer's MIP
        pixel shows)."""
        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        shape = next(iter(fields.values())).shape[-3:]
        sp = meta.get("spacing") or [1.0, 1.0, 1.0]
        org = meta.get("origin") or [0.0, 0.0, 0.0]

        def world(idx):   # (z,y,x) cell -> (x,y,z) world
            return [round(org[0] + idx[2] * sp[0], 3),
                    round(org[1] + idx[1] * sp[1], 3),
                    round(org[2] + idx[0] * sp[2], 3)]

        def values_at(idx):
            out = {}
            for name, arr in fields.items():
                v = arr[(...,) + tuple(idx)]
                if arr.ndim == 4:
                    out[name] = [round(float(c), 6) for c in v]
                    out[f"|{name}|"] = round(float(np.sqrt((v.astype(
                        np.float64) ** 2).sum())), 6)
                else:
                    out[name] = round(float(v), 6)
            return out

        if "z" in q and "y" in q and "x" in q:          # single cell
            idx = tuple(min(max(int(q[k][0]), 0), shape[i] - 1)
                        for i, k in enumerate(("z", "y", "x")))
            return {"cell": list(idx), "world": world(idx),
                    "values": values_at(idx)}

        axis = {"z": 0, "y": 1, "x": 2}[q.get("axis", ["z"])[0]]
        a = min(max(int(q.get("a", ["0"])[0]), 0),
                shape[1 if axis == 0 else 0] - 1)
        b = min(max(int(q.get("b", ["0"])[0]), 0),
                shape[2 if axis != 2 else 1] - 1)
        name = q.get("field", ["u"])[0]
        from .stream import select_scalar

        scalar = select_scalar(fields, name)
        col_idx = [slice(None)] * 3
        plane_axes = [i for i in range(3) if i != axis]
        col_idx[plane_axes[0]] = a
        col_idx[plane_axes[1]] = b
        col = scalar[tuple(col_idx)]
        k = int(np.argmax(col))
        idx = [0, 0, 0]
        idx[axis] = k
        idx[plane_axes[0]] = a
        idx[plane_axes[1]] = b
        stride = max(1, col.size // 256)
        return {
            "axis": q.get("axis", ["z"])[0], "cell": idx,
            "world": world(tuple(idx)),
            "argmax": k, "max": round(float(col[k]), 6),
            "profile": [round(float(v), 6) for v in col[::stride]],
            "profile_stride": stride,
            "values": values_at(tuple(idx)),
        }

    def api_spectra(self, q) -> bytes:
        """Wavenumber panel: per-layer horizontal kx-ky spectra of the VTK's
        velocity field on the ~every-50m layer ladder, shared log colour
        scale, plus the radial E(k) with the k^-5/3 slope — rendered live
        from the cached parse."""
        from ..io.figure import Figure, panel_size
        from ..post.les_spectra import (
            horizontal_spectrum, layer_ladder, robust_log_limits, spectrum_3d,
        )

        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        vec = next((v for v in fields.values() if v.ndim == 4), None)
        if vec is None:
            raise ValueError("spectra need a vector field")
        vec, stride = _decimate(vec)
        sp = float(meta["spacing"][0]) * stride
        u = np.asarray(vec[0], np.float64)
        fluid = fields.get("fluid")
        if fluid is not None and stride > 1:
            fluid = fluid[::stride, ::stride, ::stride]
        dz = float(q.get("dz", ["50"])[0])
        ladder = layer_ladder(u.shape[0], sp, meta["origin"][2], dz)

        spectra = []
        for k, h in ladder[:9]:
            lay = u[k]
            valid = (fluid[k] > 0.5) if fluid is not None else (lay != 0)
            if float(valid.mean()) < 0.05:
                continue
            fill = lay[valid].mean() if valid.any() else 0.0
            kx, ky, E = horizontal_spectrum(np.where(valid, lay, fill), sp)
            spectra.append((h, kx, ky, E))
        if not spectra:
            raise ValueError("no layers with enough fluid cells")
        vmin, vmax = robust_log_limits([s[3] for s in spectra])

        n = len(spectra) + 1                      # +1 for the radial E(k)
        cols = min(3, n)
        rows = (n + cols - 1) // cols
        fig = Figure(rows, cols, panel_size(len(spectra[0][1]),
                                            len(spectra[0][2]), 300),
                     title=f"{path.name} — horizontal spectra"
                     + (f" [decimated x{stride}]" if stride > 1 else ""))
        for ax, (h, kx, ky, E) in zip(fig.panels, spectra):
            ax.image(np.log10(np.maximum(E, 1e-300)), scale="iron",
                     vmin=vmin, vmax=vmax,
                     extent=(kx.min(), kx.max(), ky.min(), ky.max()))
            ax.title = f"{h:.0f} m"
        axr = fig.panels[len(spectra)]
        kc, Ek = spectrum_3d(u, sp)
        good = Ek > 0
        if good.any():
            kref, Eg = kc[good], Ek[good]
            span = (kref.min(), kref.max() if kref.max() > kref.min()
                    else kref.min() * 10.0)
            slope = Eg[0] * (kref / kref[0]) ** (-5.0 / 3.0)
            low = min(Eg.min(), slope.min())
            high = max(Eg.max(), slope.max())
            axr.limits(span, (low, high if high > low else low * 10.0),
                       xlog=True, ylog=True)
            axr.lines(kref, Eg, (0.12, 0.47, 0.71))
            axr.lines(kref, slope, (1.0, 0.5, 0.05), dashed=True)
        axr.used = True
        axr.title = "radial E(k)"
        return fig.to_png()

    def api_buildingscale(self, q) -> bytes:
        """Building-scale panel: urban canopy morphology from the VTK's
        solid mask — built-height map, height histogram, and the lambda_p /
        lambda_f metrics (post/buildingscale.morphology_stats)."""
        from ..io.figure import Figure
        from ..post.buildingscale import morphology_stats

        path = self.resolve(q["path"][0])
        meta, fields = self.vtk_cache.get(path)
        fluid = fields.get("fluid")
        if fluid is not None:
            solid = np.asarray(fluid) < 0.5
        else:
            vec = next((v for v in fields.values() if v.ndim == 4), None)
            if vec is None:
                raise ValueError("building-scale needs a fluid or vector field")
            solid = np.abs(np.asarray(vec)).sum(axis=0) == 0.0
            solid[-1] = False
        solid, stride = _decimate(solid)
        cell = float(meta["spacing"][0]) * stride
        ground_k = max(1, int(q.get("ground", ["1"])[0]))
        stats = morphology_stats(solid, cell, ground_k)
        heights = solid[ground_k:].sum(axis=0) * cell

        fig = Figure(1, 3, (320, 300), title=(
            f"{path.name} — urban morphology (cell {cell:.1f} m)"
            + (f" [decimated x{stride}]" if stride > 1 else "")))
        hmap, hist, dens = fig.panels
        hmap.image(heights, scale="rainbow")
        hmap.title = "built height (m)"
        built = heights[heights > 0]
        if built.size:
            counts, edges = np.histogram(
                built, bins=min(30, max(5, int(built.max() / cell))))
            hist.limits((edges[0], edges[-1]), (0.0, max(1, counts.max())))
            hist.bars(edges[:-1], edges[1:], counts, (0.27, 0.38, 0.5))
        hist.used = True
        hist.title = (f"height histogram (mean "
                      f"{stats['mean_height_m']:.1f} m)")
        keys = ["lambda_p", "lambda_f_x", "lambda_f_y"]
        vals = [stats[k] for k in keys]
        dens.limits((-0.5, len(keys) - 0.5), (0.0, max(max(vals), 1e-6) * 1.1))
        dens.bars(np.arange(len(keys)) - 0.4, np.arange(len(keys)) + 0.4,
                  vals, (0.5, 0.35, 0.27))
        dens.title = (f"canopy densities ({stats['built_columns']} "
                      "built columns)")
        return fig.to_png()

    def api_batch(self, q) -> dict:
        """Batch-boundary panel: per-mode batch summary — the DG inflow x
        angle case matrix for .luwdg decks, the PF direction-case table
        (angle -> unit direction -> ANG_ prefix) plus wind-profile samples
        for .luwpf, and a mode summary for .luw."""
        from ..deck import load_deck
        from ..run.modes import _format_tag

        path = self.resolve(q["path"][0])
        deck = load_deck(path)
        mode = path.suffix.lstrip(".")
        out = {"mode": mode, "casename": deck.get_text("casename", "case")}
        if mode == "luwdg":
            inflows = deck.get_float_list("inflow")
            angles = deck.get_float_list("angle")
            out["inflows"] = inflows
            out["angles"] = angles
            out["matrix"] = [[f"DG_{_format_tag(u)}_{_format_tag(a)}_"
                              for a in angles] for u in inflows]
        elif mode == "luwpf":
            from ..bc.profile import direction_from_angle, load_profile_dat

            angles = deck.get_float_list("angle")
            cases = []
            for a in angles:
                dx, dy = direction_from_angle(a)
                cases.append({"angle": a, "dir_x": round(float(dx), 4),
                              "dir_y": round(float(dy), 4),
                              "case": f"ANG_{_format_tag(a)}_"
                              if len(angles) > 1 else "(single)"})
            out["cases"] = cases
            prof = path.parent / "wind_bc" / "profile.dat"
            if prof.exists():
                z, u = load_profile_dat(prof)
                out["profile"] = [[round(float(zz), 2), round(float(uu), 3)]
                                  for zz, uu in zip(z, u)]
            out["has_xls"] = bool(sorted(path.parent.glob("*.xls")))
        else:
            out["summary"] = {
                k: deck.get_text(k, "") for k in
                ("datetime", "run_nstep", "purge_avg", "n_gpu",
                 "gpu_memory", "unsteady_output", "frame_output")
                if deck.get_text(k, "")}
        return out

    def api_profileplot(self, q) -> bytes:
        """Profile preview PNG: the U(z) curve and its sample markers from
        wind_bc/profile.dat next to the deck."""
        from ..bc.profile import load_profile_dat
        from ..io.figure import Figure

        path = self.resolve(q["path"][0])
        prof = path.parent / "wind_bc" / "profile.dat"
        z, u = load_profile_dat(prof)
        fig = Figure(1, 1, (300, 360))
        ax = fig.panels[0]
        zz = np.linspace(z.min(), z.max(), 200)
        top = max(float(z.max()), float(z.min()) + 1.0)
        right = max(float(u.max()), float(u.min()) + 1.0)
        ax.limits((min(0.0, float(u.min())), right * 1.05), (float(z.min()), top))
        ax.lines(np.interp(zz, z, u), zz, (0.27, 0.38, 0.5))
        ax.markers(u, z, (0.5, 0.35, 0.27), size=2)
        ax.title = f"{prof.parent.parent.name}/wind_bc/profile.dat"
        return fig.to_png()

    def api_aij(self, q) -> bytes:
        """Wind-tunnel validation panel (luwaij-backed): compare an executed
        .luwpf batch against the AIJ Case E dataset next to the deck and
        return the measured-vs-computed scatter figure."""
        from ..post.aij_casee import validate_deck

        path = self.resolve(q["path"][0])
        variant = q.get("variant", ["after"])[0]
        xls = sorted(path.parent.glob("*.xls"))
        if not xls:
            raise ValueError("no .xls dataset next to the deck")
        res = validate_deck(path, xls[0], variant=variant, make_figure=True)
        png = path.parent / "RESULTS" / f"aij_casee_{variant}.png"
        if not res["angles"] or not png.exists():
            raise ValueError("no ANG_*/avg VTKs found — run the deck first")
        return png.read_bytes()

    def api_env(self, q) -> dict:
        """Startup diagnostics: torch and its CUDA, the visible cards (0 is
        reported, not hidden), and whether the kernels' library for the
        current sources is built (looked up, never built here)."""
        import torch

        from ..utils import cuda_build

        info = {"python": sys.version.split()[0], "root": str(self.root),
                "torch": torch.__version__, "cuda": torch.version.cuda}
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["cards"] = n
        info["devices"] = []
        for i in range(n):
            p = torch.cuda.get_device_properties(i)
            info["devices"].append({"index": i, "name": p.name,
                                    "memory_gib": round(p.total_memory / 2**30, 1)})
        lib = cuda_build.library_path()
        info["kernels"] = {"build_dir": str(cuda_build.BUILD_DIR),
                           "library": lib.name, "built": lib.exists()}
        for mod in ("numpy", "scipy"):
            try:
                info[mod] = __import__(mod).__version__
            except ImportError:
                info[mod] = None
        return info


def make_handler(studio: Studio):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            try:
                if u.path in ("/", "/index.html"):
                    self._send(200, APP_HTML.read_bytes(), "text/html")
                elif u.path == "/api/tree":
                    self._json(studio.api_tree(q))
                elif u.path == "/api/schema":
                    self._json(studio.api_schema(q))
                elif u.path == "/api/deck":
                    self._json(studio.api_deck_get(q))
                elif u.path == "/api/job":
                    self._json(studio.api_job(q))
                elif u.path == "/api/results":
                    self._json(studio.api_results(q))
                elif u.path == "/api/vtkinfo":
                    self._json(studio.api_vtk_info(q))
                elif u.path == "/api/pick":
                    self._json(studio.api_pick(q))
                elif u.path == "/api/volinfo":
                    self._json(studio.api_volinfo(q))
                elif u.path == "/api/brick":
                    body, hdrs = studio.api_brick(q)
                    self._send(200, body, "application/octet-stream", hdrs)
                elif u.path == "/api/render":
                    self._send(200, studio.api_render(q), "image/png")
                elif u.path == "/api/series":
                    self._json(studio.api_series(q))
                elif u.path == "/api/boundary":
                    self._send(200, studio.api_boundary(q), "image/png")
                elif u.path == "/api/spectra":
                    self._send(200, studio.api_spectra(q), "image/png")
                elif u.path == "/api/batch":
                    self._json(studio.api_batch(q))
                elif u.path == "/api/profileplot":
                    self._send(200, studio.api_profileplot(q), "image/png")
                elif u.path == "/api/buildingscale":
                    self._send(200, studio.api_buildingscale(q), "image/png")
                elif u.path == "/api/aij":
                    self._send(200, studio.api_aij(q), "image/png")
                elif u.path == "/api/env":
                    self._json(studio.api_env(q))
                elif u.path == "/api/file":
                    p = studio.resolve(q["path"][0])
                    ctype = {"png": "image/png", "csv": "text/plain",
                             "log": "text/plain"}.get(
                        p.suffix.lstrip("."), "application/octet-stream")
                    self._send(200, p.read_bytes(), ctype)
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:   # noqa: BLE001 — report to the UI
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def do_POST(self):
            u = urlparse(self.path)
            n = int(self.headers.get("Content-Length", "0"))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                if u.path == "/api/deck":
                    self._json(studio.api_deck_post(body))
                elif u.path == "/api/run":
                    self._json(studio.api_run(body))
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:   # noqa: BLE001
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return Handler


class StudioServer(ThreadingHTTPServer):
    """The HTTP server of one Studio; `server_close` also stops the jobs
    still running, so no child outlives the server."""

    def __init__(self, address, studio: Studio):
        self.studio = studio
        super().__init__(address, make_handler(studio))

    def server_close(self):
        super().server_close()
        self.studio.close()


def serve(root: Path, port: int = 8750, host: str = "127.0.0.1"):
    return StudioServer((host, port), Studio(root))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="luwstudio",
                                description="LUW Studio (local web UI)")
    p.add_argument("root", nargs="?", default=".",
                   help="project root (case directory or workspace)")
    p.add_argument("--port", type=int, default=8750)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(list(sys.argv[1:] if argv is None else argv))
    root = Path(args.root).resolve()
    httpd = serve(root, args.port, args.host)
    print(f"LUW Studio: http://{args.host}:{httpd.server_address[1]}/  "
          f"(root: {root})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
