"""luwcutvis — cropped multi-altitude wind and TKE figures.

Counterpart of `latticeurbanwind_tpu/post/cut_vis.py` (host numpy;
tools_core/cut_vis.py / batch_tke_geo_viz.py): crop the averaged VTK to a
sub-box, export it as `<stem>_cropped.vtk` (byte for byte as the JAX
package writes it), and draw a 3x3 grid of altitude layers, the horizontal
speed with arrows and the TKE, through `io/figure.py` (no colour bars; the
layer heights go in the PNG's text chunk).

Crop modes:
  * GEO: deck keys `crop_min_lon / crop_max_lon / crop_min_lat /
    crop_max_lat` mapped through the case's lon/lat<->local transform;
    every VTK matching `crop_debug_file_glob` (default `*_avg-*.vtk`) in
    `crop_debug_input_dir` (default RESULTS/vtk) is cropped;
  * LOCAL: explicit `[x0 x1 y0 y1]` meters on the command line, or the
    --min-x/--max-x/--min-y/--max-y overrides.
`--dpi` (deck `crop_vis_dpi`) sets the panel size: a panel's longer side
is 3 x dpi pixels, at most 960.

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwcutvis conf.luwpf 100 500 100 500
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..deck import load_deck
from ..io.figure import Figure, panel_size
from ..io.vtk import read_structured_points, write_structured_points
from .transform import TransformModel
from .vtk2nc import discover_case_vtk_files


def crop_fields(meta, fields, crop_xy: Optional[Tuple[float, float, float, float]]):
    """Crop all fields to [x0, x1, y0, y1] in SI meters (grid-local)."""
    nx, ny, nz = meta["dims"]
    sp = meta["spacing"][0]
    if crop_xy is None:
        return fields, (0, nx, 0, ny)
    x0, x1, y0, y1 = crop_xy
    i0 = max(0, int(x0 / sp))
    i1 = min(nx, int(np.ceil(x1 / sp)))
    j0 = max(0, int(y0 / sp))
    j1 = min(ny, int(np.ceil(y1 / sp)))
    out = {k: v[..., j0:j1, i0:i1] for k, v in fields.items()}
    return out, (i0, i1, j0, j1)


def nine_layers(nz: int) -> list:
    """The nine (or fewer, distinct) layer indices of a 9-layer figure."""
    return sorted(set(int(k) for k in np.linspace(1, nz - 1, 9, dtype=int)))


def nine_layer_figure(fields, spacing: float, base_h: float, out_path: Path,
                      kind: str = "wind", dpi: int = 100,
                      quiver_step: int = 0) -> Path:
    """3x3 panels of `nine_layers`: the horizontal speed with arrows
    (kind "wind") or the TKE (kind "tke")."""
    uname = next((k for k in fields if fields[k].ndim == 4), None)
    nz = fields[uname].shape[1] if uname else next(iter(fields.values())).shape[0]
    ny, nx = next(iter(fields.values())).shape[-2:]
    fig = Figure(3, 3, panel_size(nx, ny, min(960, 3 * int(dpi))),
                 title=f"{out_path.stem}")
    for ax, k in zip(fig.panels, nine_layers(nz)):
        agl = (k + 0.5) * spacing - base_h
        if kind == "wind" and uname:
            u, v = fields[uname][0, k], fields[uname][1, k]
            speed = np.hypot(u, v)
            ax.image(speed, scale="rainbow")
            step = quiver_step or max(1, speed.shape[1] // 16)
            gx, gy = np.meshgrid(np.arange(speed.shape[1])[::step] + 0.5,
                                 np.arange(speed.shape[0])[::step] + 0.5)
            ax.arrows(gx, gy, u[::step, ::step], v[::step, ::step])
        else:
            ax.image(fields.get("tke")[k], scale="iron")
        ax.title = f"~{agl:.0f} m AGL"
    return fig.save(out_path)


def geo_crop_bounds(deck, meta) -> Optional[Tuple[float, float, float, float]]:
    """(x0, x1, y0, y1) local meters from the deck's crop_*_lon/lat keys,
    mapped through the case's lon/lat<->local transform; None if unset."""
    keys = ("crop_min_lon", "crop_max_lon", "crop_min_lat", "crop_max_lat")
    vals = [deck.get_float(k) for k in keys]
    if any(v is None for v in vals):
        return None
    lo_lon, hi_lon, lo_lat, hi_lat = vals
    nx, ny, _ = meta["dims"]
    sp = meta["spacing"][0]
    model = TransformModel.from_deck(deck, (nx * sp, ny * sp))
    # map the four crop corners and take the local-frame bounding box
    lons = np.array([lo_lon, hi_lon, hi_lon, lo_lon])
    lats = np.array([lo_lat, lo_lat, hi_lat, hi_lat])
    xs, ys = model.lonlat_to_local(lons, lats)
    return float(xs.min()), float(xs.max()), float(ys.min()), float(ys.max())


def discover_crop_inputs(deck, home: Path):
    """VTKs per the reference's input-dir fallback + file glob keys."""
    sub = deck.get_text("crop_debug_input_dir")
    candidates = ([home / sub] if sub else []) + [
        home / "RESULTS" / "vtk", home / "RESULTS", home / "proj_temp" / "vtk",
        home]
    globs = [g.strip() for g in
             (deck.get_text("crop_debug_file_glob") or "*_avg-*.vtk").split(",")
             if g.strip()]
    for d in candidates:
        if not d.is_dir():
            continue
        found = []
        for g in globs:
            found += [f for f in sorted(d.glob(g))
                      if not f.stem.endswith("_cropped")]
        if found:
            return found
    return []


def process_one(deck_path: Path, deck, vtk: Path, crop, dpi: int, *,
                quiver_step: int = 0, export_vtk: bool = True,
                cropped_vtk_path: Optional[Path] = None,
                fig_dir: Optional[Path] = None) -> list:
    meta, fields = read_structured_points(vtk)
    sp = meta["spacing"][0]
    fields, (i0, i1, j0, j1) = crop_fields(meta, fields, crop)
    written = []
    if crop is not None and export_vtk:
        out_vtk = cropped_vtk_path or vtk.with_name(vtk.stem + "_cropped.vtk")
        origin = (meta["origin"][0] + i0 * sp, meta["origin"][1] + j0 * sp,
                  meta["origin"][2])
        write_structured_points(out_vtk, {k: v.astype(np.float32)
                                          for k, v in fields.items()},
                                spacing=sp, origin=origin)
        written.append(out_vtk)
    base_h = deck.get_float("base_height", 50.0) or 50.0
    fig_dir = fig_dir or deck_path.parent / "RESULTS" / "figures"
    written.append(nine_layer_figure(fields, sp, base_h,
                                     fig_dir / f"{vtk.stem}_wind9.png",
                                     "wind", dpi=dpi, quiver_step=quiver_step))
    if "tke" in fields:
        written.append(nine_layer_figure(fields, sp, base_h,
                                         fig_dir / f"{vtk.stem}_tke9.png",
                                         "tke", dpi=dpi,
                                         quiver_step=quiver_step))
    return written


def main(argv=None) -> int:
    """CLI surface mirrors the reference's cut_vis.py argparse options
    (tools_core/cut_vis.py:1281-1348): geo lon/lat bounds, local XY bound
    overrides, quiver/dpi/figure controls, cropped-VTK export gating — all
    layered over the deck-key defaults (crop_* keys)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="luwcutvis",
        description="Cropped multi-altitude wind quiver + TKE figures")
    p.add_argument("deck", help="deck file (.luw/.luwdg/.luwpf)")
    p.add_argument("bounds", nargs="*", type=float,
                   help="optional local crop: x0 x1 y0 y1 (m)")
    p.add_argument("--min-lon", type=float, default=None)
    p.add_argument("--max-lon", type=float, default=None)
    p.add_argument("--min-lat", type=float, default=None)
    p.add_argument("--max-lat", type=float, default=None)
    p.add_argument("--min-x", type=float, default=None,
                   help="local X min override (m; beats lon/lat bounds)")
    p.add_argument("--max-x", type=float, default=None)
    p.add_argument("--min-y", type=float, default=None)
    p.add_argument("--max-y", type=float, default=None)
    p.add_argument("--quiver-step", type=int, default=0,
                   help="arrow downsample step (0 = auto)")
    p.add_argument("--dpi", type=int, default=0,
                   help="figure DPI (default: deck crop_vis_dpi or 150)")
    p.add_argument("--no-cropped-vtk", action="store_true",
                   help="skip the cropped-VTK export")
    p.add_argument("--cropped-vtk-path", default=None,
                   help="cropped VTK output path (single-input runs)")
    p.add_argument("--output-dir", default=None,
                   help="figure directory (default RESULTS/figures)")
    args = p.parse_args(list(sys.argv[1:] if argv is None else argv))

    deck_path = Path(args.deck).expanduser().resolve()
    crop_cli = tuple(args.bounds[:4]) if len(args.bounds) >= 4 else None
    deck = load_deck(deck_path)
    dt = deck.get_text("datetime") or ""
    dpi = args.dpi or int(deck.get_float("crop_vis_dpi", 150) or 150)

    # CLI lon/lat bounds override the deck's crop_* keys
    for key, val in (("crop_min_lon", args.min_lon),
                     ("crop_max_lon", args.max_lon),
                     ("crop_min_lat", args.min_lat),
                     ("crop_max_lat", args.max_lat)):
        if val is not None:
            deck.set_float(key, val)
    xy_override = (args.min_x, args.max_x, args.min_y, args.max_y)

    files = discover_crop_inputs(deck, deck_path.parent)
    if not files:
        files = [f for f in discover_case_vtk_files(deck_path.parent, dt)
                 if "_avg-" in f.name][-1:]
    if not files:
        print("luwcutvis: no averaged VTK found")
        return 1

    total = 0
    for vtk in files:
        meta, _ = read_structured_points(vtk)
        crop = crop_cli if crop_cli is not None else geo_crop_bounds(deck, meta)
        if any(v is not None for v in xy_override):
            nx, ny, _ = meta["dims"]
            sp = meta["spacing"][0]
            base = crop or (0.0, nx * sp, 0.0, ny * sp)
            crop = tuple(o if o is not None else b
                         for o, b in zip(xy_override, base))
        for out in process_one(
                deck_path, deck, vtk, crop, dpi,
                quiver_step=max(0, args.quiver_step),
                export_vtk=not args.no_cropped_vtk,
                cropped_vtk_path=(Path(args.cropped_vtk_path)
                                  if args.cropped_vtk_path
                                  and len(files) == 1 else None),
                fig_dir=Path(args.output_dir) if args.output_dir else None):
            print(f"luwcutvis: wrote {out.name}")
            total += 1
    return 0 if total else 1


if __name__ == "__main__":
    sys.exit(main())
