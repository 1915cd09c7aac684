"""luwseason — windrose-weighted seasonal synthesis of directional averages.

Counterpart of `latticeurbanwind_tpu/post/season_average.py` (host numpy;
tools_core/season_average.py): combines the per-angle averaged VTKs of a
dataset-generation / profile batch into one seasonal mean field, weighting
each direction by its windrose frequency and scaling by a speed-bin
profile, with optional resampling to a target spacing.  The season VTK,
`season_weights.csv` and `season_summary.txt` come out byte for byte as
the JAX package writes them; the 9-layer wind/tke figures go through
`cut_vis.nine_layer_figure` (`io/figure.py`).

Weight sources, in order:
  * DERIVED (reference season_average.py:432-660): a
    `wind_bc/windrose_<H>m.csv` joint direction x speed-bin probability
    table — 16 compass rows (N, NNE, ... or degree labels snapped to the
    22.5-degree set) x `C<id>_<lo>_<hi>` speed-bin columns ('p' decimal
    marker, 'inf' upper bound, % or fraction cells).  The reference speed is
    the `wind_bc/profile.dat` value at height H.  Per direction:
      probability      = sum(joint)
      velocity_weight  = sum(joint * v_bin / v_ref)
      tke_weight       = sum(joint * (v_bin / v_ref)^2)
    u_avg combines with velocity weights, tke with tke weights.
  * EXPLICIT: a weights CSV `angle,weight[,speed_scale]`.

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwseason conf.luwdg
"""

from __future__ import annotations

import math
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..deck import load_deck
from ..io.vtk import read_structured_points, write_structured_points

_ANGLE_RE = re.compile(r"(?:ANG|DG_[0-9.+-]+)_([0-9.+-]+)_")

# the 22.5-degree compass sequence (reference ANGLE_SEQUENCE)
ANGLE_SEQUENCE = [i * 22.5 for i in range(16)]
COMPASS = ["N", "NNE", "NE", "ENE", "E", "ESE", "SE", "SSE",
           "S", "SSW", "SW", "WSW", "W", "WNW", "NW", "NNW"]
_COMPASS_TO_ANGLE = {c: a for c, a in zip(COMPASS, ANGLE_SEQUENCE)}
_SPEED_BIN_RE = re.compile(
    r"^C(?P<cid>\d+)_(?P<lo>[-+]?[0-9]+(?:[p.][0-9]+)?)"
    r"_(?P<hi>[-+]?[0-9]+(?:[p.][0-9]+)?|inf)$", re.IGNORECASE)


def _custom_float(text: str) -> float:
    t = str(text).strip().lower().replace("%", "").replace("m/s", "")
    t = t.replace(" ", "").replace("p", ".").replace(",", ".")
    if t in ("inf", "+inf", "infinity"):
        return float("inf")
    return float(t)


def parse_windrose_height(path: Path) -> float:
    """Reference height in meters from `windrose_<H>m.csv`."""
    m = re.findall(r"([0-9]+(?:[p.][0-9]+)?)m", path.stem, re.IGNORECASE)
    if not m:
        raise ValueError(f"cannot parse height from windrose name {path.name}")
    return _custom_float(m[-1])


def parse_windrose_csv(path: Path):
    """-> (bin_target_speeds (B,), {angle: probs (B,)}, total_probability).

    Locates the header row by its `C<id>_<lo>_<hi>` speed-bin columns;
    direction labels may be compass names or degree values snapped to the
    22.5-degree set; percentage tables (total > 1.5) scale by 0.01."""
    import csv as _csv

    rows = None
    for enc in ("utf-8-sig", "utf-8", "latin-1"):
        try:
            with path.open("r", encoding=enc, newline="") as fh:
                rows = [[c.strip() for c in r] for r in _csv.reader(fh)]
            break
        except UnicodeDecodeError:
            continue
    if rows is None:
        raise ValueError(f"cannot read {path}")

    header_idx = None
    bins: List[Tuple[int, float, Optional[float]]] = []
    for ri, row in enumerate(rows):
        found = []
        for ci, cell in enumerate(row):
            m = _SPEED_BIN_RE.match(cell)
            if m:
                hi = m.group("hi")
                found.append((ci, _custom_float(m.group("lo")),
                              None if hi.lower() == "inf" else _custom_float(hi)))
        if found:
            header_idx, bins = ri, found
            break
    if header_idx is None:
        raise ValueError("no C<id>_<lo>_<hi> speed-bin columns found")

    widths = [hi - lo for _, lo, hi in bins if hi is not None]
    if not widths:
        raise ValueError("windrose has no finite speed bins")
    inf_half = 0.5 * sum(widths)
    targets = np.array([(0.5 * (lo + hi)) if hi is not None else lo + inf_half
                        for _, lo, hi in bins])

    min_col = min(ci for ci, _, _ in bins)
    table = {a: np.zeros(len(bins)) for a in ANGLE_SEQUENCE}
    for row in rows[header_idx + 1:]:
        if not any(c for c in row):
            continue
        angle = None
        for cell in row[:min_col]:
            label = re.sub(r"[^A-Z0-9.]+", "", cell.upper())
            if label in _COMPASS_TO_ANGLE:
                angle = _COMPASS_TO_ANGLE[label]
                break
            m = re.search(r"[-+]?\d+(?:\.\d+)?", cell)
            if m and angle is None:
                wrapped = float(m.group(0)) % 360.0
                best = min(ANGLE_SEQUENCE, key=lambda c: abs(c - wrapped))
                if abs(best - wrapped) <= 0.51:
                    angle = best
        if angle is None:
            continue
        for bi, (ci, _, _) in enumerate(bins):
            if ci < len(row) and row[ci] and row[ci].lower() not in ("-", "nan", "na"):
                try:
                    v = _custom_float(row[ci])
                except ValueError:
                    continue
                if math.isfinite(v):
                    table[angle][bi] += v

    total = float(sum(v.sum() for v in table.values()))
    if total <= 0:
        raise ValueError("windrose table has no probability mass")
    if total > 1.5:          # percentage table
        for a in table:
            table[a] = table[a] * 0.01
        total *= 0.01
    return targets, table, total


def derive_direction_weights(home: Path) -> List[tuple]:
    """[(angle, velocity_weight, tke_weight, probability)] from
    wind_bc/windrose_<H>m.csv + profile.dat (reference :546-660)."""
    wind_bc = home / "wind_bc"
    roses = sorted(wind_bc.glob("windrose_*m.csv"))
    if not roses:
        raise FileNotFoundError(f"no windrose_*m.csv under {wind_bc}")
    if len(roses) > 1:
        raise ValueError("expected exactly one windrose_*m.csv, found "
                         + ", ".join(p.name for p in roses))
    rose = roses[0]
    href = parse_windrose_height(rose)
    from ..bc.profile import _hermite_cubic, load_profile_dat

    z, u = load_profile_dat(wind_bc / "profile.dat")
    v_ref = float(_hermite_cubic(z, u, np.array([href]))[0])
    if v_ref <= 0:
        raise ValueError(f"profile speed at windrose height {href} m is "
                         f"{v_ref}; must be positive")
    targets, table, total = parse_windrose_csv(rose)
    ratios = targets / v_ref
    out = []
    print(f"luwseason: windrose {rose.name}, ref height {href:g} m, "
          f"ref speed {v_ref:.3f} m/s, total probability {total:.4f}")
    for angle in ANGLE_SEQUENCE:
        joint = table[angle] / total
        p = float(joint.sum())
        vw = float(joint @ ratios)
        tw = float(joint @ (ratios * ratios))
        out.append((angle, vw, tw, p))
    return out


def discover_directional_avgs(home: Path, datetime_tag: str, *,
                              vtk_dir: Optional[Path] = None
                              ) -> Dict[float, Path]:
    """Per-angle avg VTKs keyed by case angle.  `vtk_dir` overrides the
    default RESULTS/vtk source (reference --vtk-dir; relative paths
    resolve from the project directory, season_average.py:1713-1716).
    When several steps exist per angle the highest step wins (reference
    _pick_preferred_file, :707-720)."""
    out: Dict[float, Tuple[int, Path]] = {}
    base = (home / vtk_dir if vtk_dir is not None and not vtk_dir.is_absolute()
            else vtk_dir) or (home / "RESULTS" / "vtk")
    if not base.exists():
        return {}
    step_re = re.compile(r"-(\d+)$")
    for f in sorted(base.glob(f"*{datetime_tag}_avg-*.vtk")):
        m = _ANGLE_RE.search(f.name)
        if not m:
            continue
        sm = step_re.search(f.stem)
        step = int(sm.group(1)) if sm else 0
        a = float(m.group(1))
        if a not in out or step >= out[a][0]:
            out[a] = (step, f)
    return {a: p for a, (_, p) in out.items()}


def load_weights(path: Path) -> List[tuple]:
    rows = []
    for line in Path(path).read_text().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if not parts or not parts[0] or parts[0].lower().startswith("angle"):
            continue
        angle = float(parts[0])
        weight = float(parts[1]) if len(parts) > 1 else 1.0
        scale = float(parts[2]) if len(parts) > 2 else 1.0
        rows.append((angle, weight, scale))
    return rows


def _resample(arr: np.ndarray, factor: int) -> np.ndarray:
    """Block-average coarsening by an integer factor on the trailing 2 axes."""
    if factor <= 1:
        return arr
    *lead, Y, X = arr.shape
    Yc, Xc = Y // factor, X // factor
    a = arr[..., : Yc * factor, : Xc * factor]
    a = a.reshape(*lead, Yc, factor, Xc, factor)
    return a.mean(axis=(-3, -1))


def _axis_lerp(arr: np.ndarray, axis: int, n_out: int, ratio: float):
    """Linear resample of one axis to n_out samples at spacing ratio
    out/in (the reference's per-axis index+fraction maps,
    season_average.py:1319-1341, as one vectorized take+lerp)."""
    n_in = arr.shape[axis]
    pos = np.arange(n_out) * ratio
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = (pos - i0).astype(arr.dtype)
    shape = [1] * arr.ndim
    shape[axis] = n_out
    f = f.reshape(shape)
    a0 = np.take(arr, i0, axis=axis)
    a1 = np.take(arr, i1, axis=axis)
    return a0 * (1 - f) + a1 * f


def resample_to_spacing(fields: Dict[str, np.ndarray], in_spacing: float,
                        out_spacing: Tuple[float, float, float]):
    """Trilinear resample of every field to the requested meter spacing
    (reference --output-spacing, season_average.py:1343-1499).  Returns
    (fields, spacing tuple); the output grid spans the same extent."""
    sx, sy, sz = out_spacing
    out: Dict[str, np.ndarray] = {}
    for name, arr in fields.items():
        spatial = arr.shape[-3:]
        n_z = max(2, int(round((spatial[0] - 1) * in_spacing / sz)) + 1)
        n_y = max(2, int(round((spatial[1] - 1) * in_spacing / sy)) + 1)
        n_x = max(2, int(round((spatial[2] - 1) * in_spacing / sx)) + 1)
        a = arr.astype(np.float64)
        a = _axis_lerp(a, arr.ndim - 3, n_z, sz / in_spacing)
        a = _axis_lerp(a, arr.ndim - 2, n_y, sy / in_spacing)
        a = _axis_lerp(a, arr.ndim - 1, n_x, sx / in_spacing)
        out[name] = a
    return out, out_spacing


def _combine(avgs: Dict[float, Path], triples: List[tuple]):
    """triples: [(case_angle, vel_weight, tke_weight, prob_weight)] summed
    per field with the field-appropriate weight."""
    acc: Dict[str, np.ndarray] = {}
    meta0 = None
    for angle, vw, tw, pw in triples:
        meta, fields = read_structured_points(avgs[angle])
        if meta0 is None:
            meta0 = meta
        for name, arr in fields.items():
            arr = arr.astype(np.float64)
            if name.lower().startswith(("u", "velocity")):
                contrib = arr * vw
            elif name.lower() in ("tke", "ti", "tls"):
                contrib = arr * tw
            else:
                contrib = arr * pw
            acc[name] = contrib if name not in acc else acc[name] + contrib
    return meta0, acc


def synthesize(home: Path, datetime_tag: str, weights_path: Optional[Path],
               *, out_name: Optional[str] = None,
               resample_factor: int = 1,
               vtk_dir: Optional[Path] = None,
               output_spacing: Optional[Tuple[float, float, float]] = None,
               figures: bool = True, dpi: int = 100) -> Path:
    avgs = discover_directional_avgs(home, datetime_tag, vtk_dir=vtk_dir)
    if not avgs:
        raise FileNotFoundError("no directional averaged VTKs found")

    if weights_path is None:
        # derive from the windrose + profile (reference native path), mapping
        # each 22.5-degree rose direction onto the nearest available case
        derived = derive_direction_weights(home)
        case_angles = sorted(avgs)
        per_case: Dict[float, List[float]] = {a: [0.0, 0.0, 0.0] for a in case_angles}
        for angle, vw, tw, p in derived:
            if p <= 0 and vw <= 0:
                continue
            near = min(case_angles,
                       key=lambda c: min(abs(c - angle), 360 - abs(c - angle)))
            per_case[near][0] += vw
            per_case[near][1] += tw
            per_case[near][2] += p
        triples = [(a, v[0], v[1], v[2]) for a, v in per_case.items()]
        summary = home / "RESULTS" / "season_weights.csv"
        summary.parent.mkdir(parents=True, exist_ok=True)
        summary.write_text(
            "angle,velocity_weight,tke_weight,probability\n"
            + "\n".join(f"{a},{v:.6f},{t:.6f},{p:.6f}" for a, v, t, p in triples)
            + "\n")
        print(f"luwseason: derived weights -> {summary.name}")
    else:
        weights = load_weights(weights_path)
        if not weights:
            raise ValueError(f"no weights parsed from {weights_path}")
        missing = [a for a, _, _ in weights if a not in avgs]
        if missing:
            print(f"luwseason: WARNING missing directional avgs for angles {missing}")
        usable = [(a, w, s) for a, w, s in weights if a in avgs]
        if not usable:
            raise FileNotFoundError("no directional averaged VTKs match the weights")
        wsum = sum(w for _, w, _ in usable)
        triples = [(a, w / wsum * s, w / wsum * s * s, w / wsum)
                   for a, w, s in usable]

    meta0, acc = _combine(avgs, triples)

    # fluid mask: cells fluid in all directions
    if "fluid" in acc:
        acc["fluid"] = (acc["fluid"] > 0.999).astype(np.float32)
    in_sp = float(meta0["spacing"][0])
    if output_spacing is not None:
        if resample_factor > 1:
            print("luwseason: --output-spacing given; ignoring the integer "
                  "resample factor")
        out_fields, sp = resample_to_spacing(acc, in_sp, output_spacing)
        out_fields = {k: v.astype(np.float32) for k, v in out_fields.items()}
        fig_spacing = sp[2]    # layer-height labels need the Z spacing
        #                        (anisotropic --output-spacing: sx != sz)
    else:
        out_fields = {k: _resample(v, resample_factor).astype(np.float32)
                      for k, v in acc.items()}
        sp = in_sp * resample_factor
        fig_spacing = float(sp)
    out = home / "RESULTS" / "vtk" / (out_name or f"SEASON_{datetime_tag}_avg.vtk")
    write_structured_points(out, out_fields, spacing=sp,
                            origin=meta0["origin"])

    # summary (reference write_summary, season_average.py:1631-1691)
    summary_txt = home / "RESULTS" / "season_summary.txt"
    lines = [f"season synthesis for datetime {datetime_tag}",
             f"output: {out.name}",
             f"sources ({len(avgs)}):"]
    lines += [f"  angle {a:7.2f} deg  <-  {p.name}"
              for a, p in sorted(avgs.items())]
    lines.append("direction weights (angle, velocity, tke, probability):")
    lines += [f"  {a:7.2f}  {v:.6f}  {t:.6f}  {p:.6f}"
              for a, v, t, p in triples]
    if output_spacing is not None:
        lines.append(f"output spacing: {tuple(sp)} m (input {in_sp} m)")
    summary_txt.write_text("\n".join(lines) + "\n")

    # 9-layer wind + tke figures (reference plot_scalar_figure grids,
    # season_average.py:1539-1629; --skip-figures disables)
    if figures:
        from .cut_vis import nine_layer_figure

        fig_dir = home / "RESULTS" / "figures"
        nine_layer_figure(out_fields, fig_spacing, 0.0,
                          fig_dir / f"season_{datetime_tag}_wind.png",
                          kind="wind", dpi=dpi)
        if "tke" in out_fields:
            nine_layer_figure(out_fields, fig_spacing, 0.0,
                              fig_dir / f"season_{datetime_tag}_tke.png",
                              kind="tke", dpi=dpi)
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="luwseason",
        description="Synthesize the seasonal average wind/tke VTK from "
                    "directional average VTKs weighted by windrose "
                    "probabilities (reference season_average.py CLI).")
    parser.add_argument("deck", help="LUW-family deck (*.luw/.luwdg/.luwpf)")
    parser.add_argument("extras", nargs="*",
                        help="optional weights.csv (angle,weight[,scale]) "
                             "and/or an integer 2-D coarsening factor")
    parser.add_argument("--vtk-dir", help="directory with source *avg*.vtk "
                        "files (relative paths resolve from the project dir)")
    parser.add_argument("--output-spacing", nargs="+", type=float,
                        metavar="M", help="resample the output VTK to this "
                        "meter spacing: one value for x/y/z or three x y z")
    parser.add_argument("--skip-figures", action="store_true",
                        help="only write VTK + summary, no PNG figures")
    parser.add_argument("--dpi", type=int, default=100)
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    deck_path = Path(args.deck).expanduser().resolve()
    weights = None
    factor = 1
    for arg in args.extras:
        if arg.replace(".", "").isdigit() and "." not in arg:
            factor = int(arg)
        else:
            weights = Path(arg).expanduser().resolve()
    spacing = None
    if args.output_spacing:
        v = args.output_spacing
        if len(v) == 1:
            spacing = (v[0], v[0], v[0])
        elif len(v) == 3:
            spacing = tuple(v)
        else:
            print("luwseason: ERROR: --output-spacing takes 1 or 3 values")
            return 2
        if min(spacing) <= 0:
            print("luwseason: ERROR: --output-spacing must be positive")
            return 2
    deck = load_deck(deck_path)
    dt = deck.get_text("datetime") or ""
    try:
        out = synthesize(
            deck_path.parent, dt, weights, resample_factor=factor,
            vtk_dir=Path(args.vtk_dir) if args.vtk_dir else None,
            output_spacing=spacing, figures=not args.skip_figures,
            dpi=args.dpi)
    except (FileNotFoundError, ValueError) as e:
        print(f"luwseason: ERROR: {e}")
        return 1
    print(f"luwseason: wrote {out.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
