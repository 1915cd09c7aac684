"""luwtkeviz — multi-altitude wind and TKE layer figures.

Counterpart of `latticeurbanwind_tpu/post/tke_viz.py` (host numpy;
reference tke_viz.py / batch_tke_geo_viz.py): reads an averaged legacy
VTK, picks target-height layers by the fixed height(m) = base + step*z
mapping (reference tke_viz.py:14-16 uses -50 + 10*z), and draws a 3x3
panel grid per product through `io/figure.py`:

  * wind: the speed (rainbow, shared range up to its 99.5th percentile)
    with arrows on each XY layer;
  * tke: the TKE per layer (iron, the same shared range rule).
No colour bars; the layer titles go in the PNG's text chunk.

Modes:
  * file mode:  luwtkeviz <avg.vtk> [options]
  * batch mode: luwtkeviz --deck conf.luw — every `*_avg-*.vtk` under
    RESULTS/vtk, figures into RESULTS/tke_viz.

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwtkeviz RESULTS/vtk/<case>_avg-000000400.vtk
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

import numpy as np

from ..io.figure import Figure, panel_size
from ..io.vtk import read_structured_points

TARGET_HEIGHTS_M = [50, 100, 150, 200, 300, 400, 500, 600, 800]


def _layers(Z: int, heights: List[float], base: float, step: float):
    plan = []
    for h in heights:
        z = int(round((h - base) / step))
        if 0 <= z < Z:
            plan.append((h, z))
    return plan


def render_wind_layers(u, out_path: Path, plan, *, spacing=1.0, origin=(0.0, 0.0),
                       quiver_step: int = 0, title: str = "") -> Path:
    """u: (3, Z, Y, X) SI velocity."""
    _, Z, Y, X = u.shape
    step = quiver_step or max(1, max(Y, X) // 24)
    speed_all = np.sqrt((u ** 2).sum(axis=0))
    vmax = max(float(np.nanpercentile(speed_all, 99.5)), 1e-6)
    ext = (origin[0], origin[0] + X * spacing, origin[1], origin[1] + Y * spacing)
    xs = origin[0] + (np.arange(0, X, step) + 0.5) * spacing
    ys = origin[1] + (np.arange(0, Y, step) + 0.5) * spacing
    gx, gy = np.meshgrid(xs, ys)
    fig = Figure(3, 3, panel_size(X, Y), title=title or "wind layers")
    for ax, (h, z) in zip(fig.panels, plan):
        ax.image(speed_all[z], scale="rainbow", vmin=0.0, vmax=vmax, extent=ext)
        ax.arrows(gx, gy, u[0, z, ::step, ::step], u[1, z, ::step, ::step])
        ax.title = f"h = {h:g} m (z={z})"
    return fig.save(out_path)


def render_tke_layers(tke, out_path: Path, plan, *, spacing=1.0,
                      origin=(0.0, 0.0), title: str = "") -> Path:
    Z, Y, X = tke.shape
    vmax = max(float(np.nanpercentile(tke, 99.5)), 1e-9)
    ext = (origin[0], origin[0] + X * spacing, origin[1], origin[1] + Y * spacing)
    fig = Figure(3, 3, panel_size(X, Y), title=title or "TKE layers")
    for ax, (h, z) in zip(fig.panels, plan):
        ax.image(tke[z], scale="iron", vmin=0.0, vmax=vmax, extent=ext)
        ax.title = f"h = {h:g} m (z={z})"
    return fig.save(out_path)


def render_file(vtk_path: Path, out_dir: Path, *, heights, base: float,
                step: float, quiver_step: int) -> List[Path]:
    meta, fields = read_structured_points(vtk_path)
    spacing = float(meta.get("spacing", (1.0, 1.0, 1.0))[0]) if isinstance(
        meta.get("spacing"), (tuple, list)) else float(meta.get("spacing", 1.0))
    org = meta.get("origin", (0.0, 0.0, 0.0))
    u = fields.get("u_avg")
    if u is None:
        u = fields.get("data")    # raw velocity VTK
    written: List[Path] = []
    stem = vtk_path.stem
    if u is not None and u.ndim == 4:
        Z = u.shape[1]
        plan = _layers(Z, heights, base, step)
        if not plan:
            plan = [(base + step * z, z) for z in
                    np.linspace(0, Z - 1, min(9, Z)).astype(int)]
        written.append(render_wind_layers(
            u, out_dir / f"{stem}_wind_layers.png", plan, spacing=spacing,
            origin=(org[0], org[1]), quiver_step=quiver_step, title=stem))
    tke = fields.get("tke")
    if tke is not None:
        Z = tke.shape[0]
        plan = _layers(Z, heights, base, step)
        if not plan:
            plan = [(base + step * z, z) for z in
                    np.linspace(0, Z - 1, min(9, Z)).astype(int)]
        written.append(render_tke_layers(
            tke, out_dir / f"{stem}_tke_layers.png", plan, spacing=spacing,
            origin=(org[0], org[1]), title=stem))
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="luwtkeviz",
        description="multi-altitude wind/TKE layer figures from averaged VTK")
    p.add_argument("vtk", nargs="?", help="avg VTK file (or use --deck)")
    p.add_argument("--deck", help="deck file: batch over RESULTS/vtk/*_avg-*.vtk")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--heights", type=float, nargs="+", default=TARGET_HEIGHTS_M)
    p.add_argument("--base-height", type=float, default=-50.0,
                   help="height of z=0 in m (reference mapping: -50)")
    p.add_argument("--layer-step", type=float, default=10.0,
                   help="metres per z layer (reference mapping: 10)")
    p.add_argument("--quiver-step", type=int, default=0)
    args = p.parse_args(list(sys.argv[1:] if argv is None else argv))

    targets: List[Path] = []
    if args.deck:
        deck_dir = Path(args.deck).resolve().parent
        targets = sorted((deck_dir / "RESULTS" / "vtk").glob("*_avg-*.vtk"))
        if not targets:
            print(f"luwtkeviz: no averaged VTKs under {deck_dir}/RESULTS/vtk")
            return 1
        out_dir = Path(args.out) if args.out else deck_dir / "RESULTS" / "tke_viz"
    elif args.vtk:
        targets = [Path(args.vtk)]
        out_dir = Path(args.out) if args.out else targets[0].parent
    else:
        p.print_usage()
        return 2

    n = 0
    for t in targets:
        for f in render_file(t, out_dir, heights=args.heights,
                             base=args.base_height, step=args.layer_step,
                             quiver_step=args.quiver_step):
            print(f"wrote {f}")
            n += 1
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
