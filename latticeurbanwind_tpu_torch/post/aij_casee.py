"""AIJ Niigata Case E wind-tunnel validation (`luwaij`).

Counterpart of `latticeurbanwind_tpu/post/aij_casee.py` (host numpy).  The
AIJ Case E workbook (`CaseE(Niigata).xls`) holds 80 pedestrian-level
measurement points around the Niigata city block, the normalized inflow
profile (z/ZR, U/UR, k/UR^2 with ZR = 250 m, UR = 7.8 m/s), and
wind-tunnel velocity ratios at 2 m above ground, normalized by the inflow
speed at 15.9 m, for 16 compass directions and two city configurations
(before/after construction of the high-rises).

This tool samples the time-averaged wind field of an executed `.luwpf`
profile batch on the Case E geometry at the measurement points and reports
Pearson r, RMSE, bias and the fraction within +/-30 %, with a CSV of the
pairs, a measured-vs-computed scatter figure and an error map of the first
angle, drawn through `io/figure.py` (no text: titles, axes and the legend
go in the PNG's text chunk).

Geometry frame: the measurement points are given in meters from the center
of the reproducing area; the PF domain is the building area expanded by
`x_exp_rat`/`y_exp_rat`, so the building-area center is the domain center,
and the avg VTK's origin is the cell-centered box centered on (0, 0)
(io/vtk.py) — the points map 1:1 into VTK coordinates.  Heights: the PF
pedestal occupies [0, base_height] in lattice z, so the 2 m measurement
plane sits at base_height + 2.

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwaij conf.luwpf --xls "CaseE(Niigata).xls"
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.figure import Figure
from ..io.vtk import read_structured_points
from ..io.xls import load_xls
from ..run.fieldvis import colorscale_rainbow, colorscale_twocolor

COMPASS16 = ("N", "NNE", "NE", "ENE", "E", "ESE", "SE", "SSE",
             "S", "SSW", "SW", "WSW", "W", "WNW", "NW", "NNW")
MET_STATION_AGL_M = 15.9        # normalization height (xls "Results" note)
MEASURE_AGL_M = 2.0             # measurement height above ground


@dataclass
class AijCaseE:
    """Parsed Case E workbook."""

    point_no: np.ndarray          # (N,) 1-based ids
    points: np.ndarray            # (N, 2) x-east / y-north, m, origin = center
    inflow_z_zr: np.ndarray       # normalized inflow profile
    inflow_u_ur: np.ndarray
    inflow_k_ur2: np.ndarray
    ratios: Dict[str, np.ndarray]  # variant -> (N, 16) velocity ratios


def load_aij_casee(xls_path: Path | str) -> AijCaseE:
    wb = load_xls(xls_path)

    geo = wb.rows("Geometry&Points")
    no, pts = [], []
    for row in geo:
        if (len(row) >= 4 and isinstance(row[1], float)
                and isinstance(row[2], float) and isinstance(row[3], float)):
            no.append(int(row[1]))
            pts.append((row[2], row[3]))

    inf = wb.rows("Inflow")
    prof = [(r[1], r[2], r[3]) for r in inf
            if len(r) >= 4 and all(isinstance(v, float) for v in r[1:4])]

    ratios: Dict[str, np.ndarray] = {}
    for variant, sheet in (("before", "Results (Before Construction)"),
                           ("after", "Results (After Construction)")):
        rows = wb.rows(sheet)
        # header row: the 16 compass labels; map columns by label
        col_of: Dict[str, int] = {}
        for row in rows:
            for ci, v in enumerate(row):
                if isinstance(v, str) and v.strip() in COMPASS16:
                    col_of[v.strip()] = ci
            if len(col_of) == 16:
                break
        table = np.full((len(no), 16), np.nan)
        for row in rows:
            if len(row) > 1 and isinstance(row[1], float):
                pid = int(row[1])
                if 1 <= pid <= len(no):
                    for di, name in enumerate(COMPASS16):
                        ci = col_of.get(name)
                        if ci is not None and ci < len(row) \
                                and isinstance(row[ci], float):
                            table[pid - 1, di] = row[ci]
        ratios[variant] = table

    return AijCaseE(
        point_no=np.asarray(no), points=np.asarray(pts, dtype=np.float64),
        inflow_z_zr=np.asarray([p[0] for p in prof]),
        inflow_u_ur=np.asarray([p[1] for p in prof]),
        inflow_k_ur2=np.asarray([p[2] for p in prof]),
        ratios=ratios)


def compass_column(angle_deg: float) -> int:
    """Wind-direction angle (deg from north, the deck `angle` convention:
    the direction the wind comes FROM) -> nearest 16-compass column."""
    return int(round((angle_deg % 360.0) / 22.5)) % 16


def reference_speed(z_samples: np.ndarray, u_samples: np.ndarray,
                    agl_m: float = MET_STATION_AGL_M,
                    domain_agl_m: Optional[float] = None) -> float:
    """Inflow speed at the normalization height via the same cubic profile
    interpolation the solver's profile mode uses (bc/profile.ProfileTable).

    `domain_agl_m` (domain height above the pedestal) matters for
    NORMALIZED profile.dat files (z up to ~1): ProfileTable rescales those
    by the domain height, so the same value the run used must be passed or
    u_ref silently disagrees with the solver's inflow.  Metric profiles
    (like Case E's, z up to 250 m) are unaffected."""
    from ..bc.profile import ProfileTable

    zmax = float(np.max(z_samples))
    if domain_agl_m is None:
        if zmax <= 1.5:
            raise ValueError(
                "normalized profile.dat needs domain_agl_m (= si_z_cfd top "
                "- base_height) to rescale like the solver run did")
        domain_agl_m = zmax
    top = max(zmax, domain_agl_m, agl_m) + 1.0
    table = ProfileTable.build(z_samples, u_samples, top, domain_agl_m)
    return float(table.speed_at_agl(np.asarray([agl_m]))[0])


def sample_ratios(meta: dict, fields: dict, points_xy: np.ndarray,
                  u_ref_si: float, base_height_m: float,
                  measure_agl_m: float = MEASURE_AGL_M) -> np.ndarray:
    """Horizontal-speed ratio at the measurement points.

    Bilinear in (x, y) at the z layer whose cell center is nearest
    base_height + measure_agl; solid cells (fluid mask 0) drop out of the
    stencil with weight renormalization, NaN where the whole stencil is
    solid."""
    u = next((v for k, v in fields.items() if v.ndim == 4), None)
    if u is None:
        raise ValueError("avg VTK has no vector field")
    fluid = fields.get("fluid")
    origin = meta["origin"]
    sp = float(meta["spacing"][0])
    Z, Y, X = u.shape[1:]

    z_target = base_height_m + measure_agl_m
    # VTK z of layer k is origin_z + k*sp; lattice z of that center is
    # (k + 0.5)*sp above the domain floor.  On grids coarser than the
    # measurement height the nominal layer can sit inside the ground
    # pedestal — climb to the first layer with fluid in the stencil
    # (pedestrian level = lowest fluid cell at-or-above ground + 2 m).
    k0 = int(np.clip(round(z_target / sp - 0.5), 0, Z - 1))
    k_max = min(Z - 1, k0 + 4)

    def _layer(k):
        spd = np.sqrt(u[0, k].astype(np.float64) ** 2
                      + u[1, k].astype(np.float64) ** 2)
        ok = (fluid[k] > 0.5).astype(np.float64) if fluid is not None \
            else (spd > 0).astype(np.float64)
        return spd, ok

    layers = {k: _layer(k) for k in range(k0, k_max + 1)}

    out = np.full(len(points_xy), np.nan)
    for i, (px, py) in enumerate(points_xy):
        gx = (px - origin[0]) / sp
        gy = (py - origin[1]) / sp
        x0 = int(np.floor(gx))
        y0 = int(np.floor(gy))
        if not (0 <= x0 < X - 1 and 0 <= y0 < Y - 1):
            continue
        fx, fy = gx - x0, gy - y0
        w = np.array([(1 - fx) * (1 - fy), fx * (1 - fy),
                      (1 - fx) * fy, fx * fy])
        for k in range(k0, k_max + 1):
            speed, w_ok = layers[k]
            vals = np.array([speed[y0, x0], speed[y0, x0 + 1],
                             speed[y0 + 1, x0], speed[y0 + 1, x0 + 1]])
            oks = np.array([w_ok[y0, x0], w_ok[y0, x0 + 1],
                            w_ok[y0 + 1, x0], w_ok[y0 + 1, x0 + 1]])
            wt = w * oks
            if wt.sum() > 0:
                out[i] = float((vals * wt).sum() / wt.sum()) / u_ref_si
                break
    return out


def compare(measured: np.ndarray, computed: np.ndarray) -> dict:
    """Standard validation statistics over the valid pairs."""
    ok = np.isfinite(measured) & np.isfinite(computed)
    m, c = measured[ok], computed[ok]
    if len(m) < 3:
        return {"n": int(len(m)), "r": float("nan"), "rmse": float("nan"),
                "bias": float("nan"), "within30": float("nan")}
    r = float(np.corrcoef(m, c)[0, 1])
    rmse = float(np.sqrt(np.mean((c - m) ** 2)))
    bias = float(np.mean(c - m))
    base = np.maximum(m, 0.1)           # avoid inflating tiny-ratio errors
    within = float(np.mean(np.abs(c - m) <= 0.3 * base))
    return {"n": int(ok.sum()), "r": round(r, 3), "rmse": round(rmse, 3),
            "bias": round(bias, 3), "within30": round(within, 3)}


def _find_avg_vtk(vtk_dir: Path, prefix: str) -> Optional[Path]:
    """Highest-step `<prefix>*_avg-<t>.vtk` under the case RESULTS."""
    best, best_t = None, -1
    for f in vtk_dir.glob(f"{prefix}*_avg-*.vtk"):
        try:
            t = int(f.stem.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            continue
        if t > best_t:
            best, best_t = f, t
    return best


def scatter_figure(out: Path, pairs, overall: dict, variant: str) -> Path:
    """Measured (x) against computed (y) ratios, one colour per angle
    (rainbow ramp), with the 1:1 line and the +-30 % lines dashed."""
    all_m = np.concatenate([m for _, m, _ in pairs])
    all_c = np.concatenate([c for _, _, c in pairs])
    lim = 0.05 + max(float(np.nanmax(all_m)), float(np.nanmax(all_c)), 1.0)
    legend = ", ".join(f"{a:g} deg ({COMPASS16[compass_column(a)]})"
                       for a, _, _ in pairs)
    fig = Figure(1, 1, (480, 480), title=(
        f"AIJ Niigata Case E ({variant} construction) r={overall['r']} "
        f"rmse={overall['rmse']} bias={overall['bias']} n={overall['n']}; "
        "x wind tunnel velocity ratio (2 m / 15.9 m inflow), y LBM-LES "
        f"velocity ratio; angles {legend}"))
    ax = fig.panels[0].limits((0.0, lim), (0.0, lim))
    xs = np.linspace(0, lim, 2)
    ax.lines(xs, xs)
    ax.lines(xs, 1.3 * xs, dashed=True)
    ax.lines(xs, 0.7 * xs, dashed=True)
    colors = colorscale_rainbow(np.linspace(0.1, 0.9, len(pairs)))
    for (_, m, c), col in zip(pairs, colors):
        ax.markers(m, c, col)
    return fig.save(out)


def error_map(out: Path, vtk: Path, points: np.ndarray, pair,
              base_height: float, variant: str) -> Optional[Path]:
    """One angle's points at their (x, y) over the solid footprint above
    the measurement layer (grey), coloured by computed - measured
    (two-colour ramp over a symmetric range); best-effort."""
    angle0, m0, c0 = pair
    try:
        meta0, fields0 = read_structured_points(vtk)
        fig = Figure(1, 1, (480, 480), title=(
            f"AIJ Case E error map - angle {angle0:g} deg "
            f"({COMPASS16[compass_column(angle0)]}, {variant}); "
            "x east (m), y north (m), colour computed - measured ratio"))
        ax = fig.panels[0]
        span = float(np.abs(points).max()) * 1.3
        ax.limits((-span, span), (-span, span))
        fluid0 = fields0.get("fluid")
        if fluid0 is not None:
            sp = float(meta0["spacing"][0])
            k0 = int(round((base_height + MEASURE_AGL_M) / sp - 0.5))
            k0 = min(max(k0, 0), fluid0.shape[0] - 1)
            solid = fluid0[min(k0 + 1, fluid0.shape[0] - 1)] < 0.5
            ny, nx = solid.shape
            ox, oy = meta0["origin"][0], meta0["origin"][1]
            ax.image(np.where(solid, 0.55, 1.0), scale="gray", vmin=0.0, vmax=1.0,
                     extent=(ox, ox + sp * (nx - 1), oy, oy + sp * (ny - 1)))
        err = c0 - m0
        lim_e = max(0.1, float(np.nanmax(np.abs(err))))
        ax.markers(points[:, 0], points[:, 1], colorscale_twocolor(
            0.5 + 0.5 * np.nan_to_num(err) / lim_e, background=(1.0, 1.0, 1.0)),
            size=3)
        return fig.save(out)
    except Exception as e:   # noqa: BLE001 — the map is best-effort
        print(f"| AIJ Case E | error map skipped: {e}")
        return None


def validate_deck(deck_path: Path | str, xls_path: Path | str, *,
                  variant: str = "after", angles: Optional[Sequence[float]] = None,
                  out_dir: Optional[Path] = None, make_figure: bool = True,
                  ) -> dict:
    """Compare an executed `.luwpf` batch against the Case E measurements.

    Returns {"angles": {angle: stats}, "overall": stats, ...}; writes
    `aij_casee_<variant>.png` + `aij_casee_<variant>.csv` next to RESULTS.
    """
    from ..bc.profile import load_profile_dat
    from ..deck import load_deck

    deck_path = Path(deck_path)
    parent = deck_path.parent
    deck = load_deck(deck_path)
    ds = load_aij_casee(xls_path)
    if variant not in ds.ratios:
        raise ValueError(f"variant {variant!r} not in {list(ds.ratios)}")

    deck_angles = deck.get_float_list("angle") or [0.0]
    angles = list(angles) if angles is not None else deck_angles
    single = len(deck_angles) == 1
    base_height = deck.get_float("base_height", 20.0) or 20.0

    z_s, u_s = load_profile_dat(parent / "wind_bc" / "profile.dat")
    domain_agl = None
    z_rng = deck.get_pair("si_z_cfd")
    if z_rng and len(z_rng) == 2:
        domain_agl = float(z_rng[1] - z_rng[0]) - base_height
    u_ref = reference_speed(z_s, u_s, domain_agl_m=domain_agl
                            if domain_agl and domain_agl > 0 else None)

    vtk_dir = parent / "RESULTS" / "vtk"
    from ..run.modes import _format_tag

    out_dir = Path(out_dir) if out_dir else parent / "RESULTS"
    out_dir.mkdir(parents=True, exist_ok=True)

    per_angle: Dict[float, dict] = {}
    pairs: List[Tuple[float, np.ndarray, np.ndarray]] = []
    for angle in angles:
        # the un-prefixed naming exists only for the single-angle run's own
        # angle; any OTHER requested angle must look for its ANG_ prefix
        # (and correctly find nothing rather than re-matching angle 0)
        prefix = ("" if single and angle == deck_angles[0]
                  else f"ANG_{_format_tag(angle)}_")
        vtk = _find_avg_vtk(vtk_dir, prefix)
        if vtk is None:
            print(f"| AIJ Case E | angle={angle}: no {prefix}*_avg-*.vtk yet "
                  f"in {vtk_dir} — skipped")
            continue
        meta, fields = read_structured_points(vtk)
        computed = sample_ratios(meta, fields, ds.points, u_ref, base_height)
        measured = ds.ratios[variant][:, compass_column(angle)]
        stats = compare(measured, computed)
        stats["vtk"] = vtk.name
        per_angle[angle] = stats
        pairs.append((angle, measured, computed))
        print(f"| AIJ Case E | angle={angle} ({COMPASS16[compass_column(angle)]}) "
              f"n={stats['n']} r={stats['r']} rmse={stats['rmse']} "
              f"bias={stats['bias']} within30%={stats['within30']}")

    if not pairs:
        return {"angles": {}, "overall": compare(np.array([]), np.array([])),
                "u_ref": u_ref}

    all_m = np.concatenate([m for _, m, _ in pairs])
    all_c = np.concatenate([c for _, _, c in pairs])
    overall = compare(all_m, all_c)
    print(f"| AIJ Case E | OVERALL ({variant}) n={overall['n']} "
          f"r={overall['r']} rmse={overall['rmse']} bias={overall['bias']} "
          f"within30%={overall['within30']}")

    # CSV artifact: per-point rows for every angle
    csv = out_dir / f"aij_casee_{variant}.csv"
    with csv.open("w") as fh:
        fh.write("angle,point,x,y,measured,computed\n")
        for angle, m, c in pairs:
            for i in range(len(ds.point_no)):
                fh.write(f"{angle},{ds.point_no[i]},{ds.points[i, 0]},"
                         f"{ds.points[i, 1]},{m[i]:.4f},{c[i]:.4f}\n")

    if make_figure:
        error_map(out_dir / f"aij_casee_map_{variant}.png",
                  vtk_dir / per_angle[pairs[0][0]]["vtk"], ds.points,
                  pairs[0], base_height, variant)
        scatter_figure(out_dir / f"aij_casee_{variant}.png", pairs, overall,
                       variant)

    return {"angles": per_angle, "overall": overall, "u_ref": u_ref,
            "csv": str(csv)}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="luwaij",
        description="Validate a .luwpf run against the AIJ Case E "
                    "wind-tunnel dataset")
    p.add_argument("deck", help="path to the .luwpf deck (run it first)")
    p.add_argument("--xls", default=None,
                   help="CaseE workbook (default: CaseE*.xls next to the deck)")
    p.add_argument("--variant", choices=("before", "after"), default="after")
    p.add_argument("--angles", default=None,
                   help="comma list of angles to compare (default: deck angles)")
    p.add_argument("--no-figure", action="store_true")
    args = p.parse_args(list(sys.argv[1:] if argv is None else argv))

    deck_path = Path(args.deck)
    xls = Path(args.xls) if args.xls else None
    if xls is None:
        cands = sorted(deck_path.parent.glob("CaseE*.xls")) + \
            sorted(deck_path.parent.glob("*.xls"))
        if not cands:
            print("ERROR: no .xls dataset found next to the deck; use --xls")
            return 2
        xls = cands[0]
    angles = ([float(a) for a in args.angles.split(",")]
              if args.angles else None)
    res = validate_deck(deck_path, xls, variant=args.variant, angles=angles,
                        make_figure=not args.no_figure)
    return 0 if res["angles"] else 1


if __name__ == "__main__":
    sys.exit(main())
