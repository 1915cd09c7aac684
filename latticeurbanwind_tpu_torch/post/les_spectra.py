"""luwspectra — turbulence energy-spectrum diagnostics.

Counterpart of `latticeurbanwind_tpu/post/les_spectra.py` (host numpy
float64, as the JAX package computes them; tools_core/les_spectra.py):
  * horizontal kx-ky spectra on height layers every `--height-interval`
    meters (default 50 m), each with a valid-point coverage fraction from
    the fluid/nonzero mask, one PNG per layer plus an overview panel with
    shared robust log colour limits and a layer metadata CSV;
  * a radially-binned 3-D isotropic energy spectrum E(k) with the
    Kolmogorov k^-5/3 reference slope, PNG + CSV;
  * 1-D frequency spectra from probe CSV time series.
The CSVs equal the JAX package's; the log-log plots and the kx-ky maps
(iron colour scale) go through `io/figure.py`, titles in the PNG's text
chunk.

    python -m latticeurbanwind_tpu_torch.cli.dispatch luwspectra RESULTS/vtk/<case>_raw_u-000000400.vtk
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..deck import load_deck
from ..io.figure import Figure, panel_size
from ..io.vtk import read_structured_points
from .vtk2nc import discover_case_vtk_files


def spectrum_from_series(u: np.ndarray, dt: float):
    """One-sided energy spectrum of a velocity time series."""
    u = np.asarray(u, float)
    u = u - u.mean()
    n = len(u)
    if n < 8:
        return None
    freq = np.fft.rfftfreq(n, dt)[1:]
    amp = np.fft.rfft(u * np.hanning(n))[1:]
    E = (np.abs(amp) ** 2) * 2.0 * dt / n
    return freq, E


def spectrum_3d(u: np.ndarray, spacing: float, nbins: int = 40):
    """Radially-binned 3-D energy spectrum E(k).

    `u` is (Z, Y, X) for one component or (C, Z, Y, X) for several —
    components sum as 0.5 sum|u_c(k)|^2 (the reference's isotropic
    spectrum over u, v, w; les_spectra.py:414-521).  The x axis uses a
    one-sided rfft with 2x interior-bin weights (compute_kx_weights,
    :403-412) so memory stays ~half of a full fftn."""
    u = np.asarray(u, float)
    if u.ndim == 3:
        u = u[None]
    C, Z, Y, X = u.shape
    kz = np.fft.fftfreq(Z, spacing)
    ky = np.fft.fftfreq(Y, spacing)
    kx = np.fft.rfftfreq(X, spacing)
    wx = np.ones(len(kx))
    if len(wx) > 1:
        if X % 2 == 0:
            wx[1:-1] = 2.0
        else:
            wx[1:] = 2.0
    Ek3 = np.zeros((Z, Y, len(kx)))
    for c in range(C):
        comp = u[c] - u[c].mean()
        uk = np.fft.rfftn(comp)
        Ek3 += 0.5 * (np.abs(uk) ** 2) * wx[None, None, :] / (X * Y * Z) ** 2
    kmag = np.sqrt(kz[:, None, None] ** 2 + ky[None, :, None] ** 2
                   + kx[None, None, :] ** 2)
    kmax = kmag.max()
    bins = np.linspace(0, kmax, nbins + 1)
    which = np.digitize(kmag.ravel(), bins) - 1
    E = np.bincount(which, weights=Ek3.ravel(), minlength=nbins)[:nbins]
    kc = 0.5 * (bins[:-1] + bins[1:])
    return kc[1:], E[1:]


def full_coverage_z_start(fluid: Optional[np.ndarray]) -> int:
    """First z layer with 100% fluid coverage — the 3-D spectrum subvolume
    starts there so buildings/terrain don't alias into E(k) (reference
    compute_isotropic_spectrum, les_spectra.py:421-427)."""
    if fluid is None:
        return 0
    cov = (fluid > 0.5).reshape(fluid.shape[0], -1).mean(axis=1)
    full = np.where(np.isclose(cov, 1.0))[0]
    if full.size == 0:
        raise RuntimeError("no fully-fluid horizontal layer for the 3-D "
                           "spectrum")
    return int(full[0])


def isotropic_report(vtk_path: Path, fig_dir: Path, *,
                     quick_layers: Optional[int] = None) -> list:
    """Isotropic E(k) over the fully-fluid subvolume: figure with the
    k^-5/3 reference slope + CSV (reference plot_isotropic_spectrum /
    save_isotropic_csv, les_spectra.py:523-652)."""
    meta, fields = read_structured_points(vtk_path)
    sp = meta["spacing"][0]
    uname = next((k for k in fields if fields[k].ndim == 4), None)
    if uname is None:
        return []
    u = fields[uname]
    z0 = full_coverage_z_start(fields.get("fluid"))
    z1 = u.shape[1]
    if quick_layers is not None:
        z1 = min(z1, z0 + max(4, int(quick_layers)))
    k, E = spectrum_3d(u[:, z0:z1], sp)
    good = E > 0
    k, E = k[good], E[good]
    if not len(k):
        return []

    csv_out = fig_dir / f"{vtk_path.stem}_Ek.csv"
    csv_out.write_text("k_inv_m,E_k\n"
                       + "\n".join(f"{kk:.8e},{ee:.8e}"
                                   for kk, ee in zip(k, E)) + "\n")
    mid = slice(len(k) // 4, max(len(k) // 4 + 2, 3 * len(k) // 4))
    kref = k[mid]
    png_out = loglog_figure(
        fig_dir / f"{vtk_path.stem}_Ek.png", k, E, kref,
        title=f"{vtk_path.stem} isotropic spectrum; E(k), z {z0}:{z1}; "
              "dashed k^-5/3; x k (1/m), y E(k)")
    return [png_out, csv_out]


def loglog_figure(out: Path, x: np.ndarray, y: np.ndarray,
                  x_ref: np.ndarray, *, title: str) -> Path:
    """y(x) on log-log axes with the -5/3 slope dashed over `x_ref`,
    anchored on the curve at its first point."""
    fig = Figure(1, 1, (560, 400), title=title)
    ax = fig.panels[0]
    pos = y[y > 0]
    ax.limits((x.min(), x.max()), (pos.min(), pos.max()), xlog=True, ylog=True)
    ax.lines(x, y, (0.1, 0.3, 0.8))
    if len(x_ref):
        anchor = float(np.interp(x_ref[0], x, y))
        ax.lines(x_ref, anchor * (x_ref / x_ref[0]) ** (-5.0 / 3.0),
                 (0.0, 0.0, 0.0), dashed=True)
    return fig.save(out)


def horizontal_spectrum(layer: np.ndarray, spacing: float):
    """2-D kx-ky energy spectrum of one (Y, X) horizontal layer (Hann
    windowed, fftshifted; reference compute_horizontal_energy_spectrum)."""
    lay = np.asarray(layer, float)
    lay = lay - lay.mean()
    Y, X = lay.shape
    win = np.hanning(Y)[:, None] * np.hanning(X)[None, :]
    F = np.fft.fftshift(np.fft.fft2(lay * win))
    E = np.abs(F) ** 2 / (X * Y) ** 2
    kx = np.fft.fftshift(np.fft.fftfreq(X, spacing))
    ky = np.fft.fftshift(np.fft.fftfreq(Y, spacing))
    return kx, ky, E


def layer_ladder(nz: int, spacing: float, z0: float, dz_target: float = 50.0,
                 start_m: Optional[float] = None):
    """[(k, height_m)] every ~dz_target meters from start_m (reference
    build_target_heights: --height-start/--height-interval, :187-209)."""
    heights = z0 + (np.arange(nz) + 0.5) * spacing
    first = heights[0] if start_m is None else max(heights[0], start_m)
    targets = np.arange(first, heights[-1] + 1e-6, dz_target)
    out, seen = [], set()
    for t in targets:
        k = int(np.argmin(np.abs(heights - t)))
        if k not in seen:
            seen.add(k)
            out.append((k, float(heights[k])))
    return out


def robust_log_limits(arrs, lo_pct=5.0, hi_pct=99.5):
    """Shared color limits over log10 spectra (reference :253-263)."""
    vals = np.concatenate([a[a > 0].ravel() for a in arrs if (a > 0).any()])
    if not len(vals):
        return -12.0, 0.0
    lv = np.log10(vals)
    return float(np.percentile(lv, lo_pct)), float(np.percentile(lv, hi_pct))


def horizontal_layer_report(vtk_path: Path, fig_dir: Path, *,
                            dz_target: float = 50.0,
                            start_m: Optional[float] = None,
                            max_heights: Optional[int] = None) -> list:
    """Per-layer kx-ky spectra + overview + metadata CSV; returns paths."""
    meta, fields = read_structured_points(vtk_path)
    sp = meta["spacing"][0]
    uname = next((k for k in fields if fields[k].ndim == 4), None)
    if uname is None:
        return []
    u = fields[uname][0]
    fluid = fields.get("fluid")
    nz = u.shape[0]
    ladder = layer_ladder(nz, sp, meta["origin"][2], dz_target, start_m)
    if max_heights is not None:      # --quick-test subset (reference :89-99)
        ladder = ladder[:max_heights]

    records, spectra = [], []
    for k, h in ladder:
        lay = u[k]
        valid = (fluid[k] > 0.5) if fluid is not None else (lay != 0)
        frac = float(valid.mean())
        if frac < 0.05:
            continue
        kx, ky, E = horizontal_spectrum(np.where(valid, lay, lay[valid].mean()
                                                 if valid.any() else 0.0), sp)
        spectra.append((k, h, frac, kx, ky, E))
    if not spectra:
        return []
    vmin, vmax = robust_log_limits([s[5] for s in spectra])

    def draw(ax, kx, ky, E):
        ax.image(np.log10(np.maximum(E, 1e-300)), scale="iron", vmin=vmin,
                 vmax=vmax, extent=(kx.min(), kx.max(), ky.min(), ky.max()))

    written = []
    for k, h, frac, kx, ky, E in spectra:
        fig = Figure(1, 1, panel_size(len(kx), len(ky), 400),
                     title=f"kx-ky spectrum @ {h:.0f} m (valid {frac * 100:.0f}%); "
                           "x kx (1/m), y ky (1/m), log10 E")
        draw(fig.panels[0], kx, ky, E)
        out = fig.save(fig_dir / f"{vtk_path.stem}_kxky_{h:.0f}m.png")
        written.append(out)
        records.append((h, k, frac, out.name))

    # overview panel with the shared color scale
    n = len(spectra)
    cols = min(3, n)
    rows = (n + cols - 1) // cols
    fig = Figure(rows, cols, panel_size(len(spectra[0][3]), len(spectra[0][4]), 300),
                 title=f"{vtk_path.stem} horizontal spectra")
    for ax, (k, h, frac, kx, ky, E) in zip(fig.panels, spectra):
        draw(ax, kx, ky, E)
        ax.title = f"{h:.0f} m"
    written.append(fig.save(fig_dir / f"{vtk_path.stem}_kxky_overview.png"))

    csv_out = fig_dir / f"{vtk_path.stem}_kxky_layers.csv"
    csv_out.write_text(
        "height_m,z_index,valid_fraction,png\n"
        + "\n".join(f"{h:.2f},{k},{f:.4f},{n}" for h, k, f, n in records) + "\n")
    written.append(csv_out)
    return written


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="luwspectra",
        description="Horizontal kx-ky spectra per height layer + 3-D "
                    "isotropic E(k) for LES resolution checks "
                    "(reference les_spectra.py CLI).")
    parser.add_argument("target", help="LUW deck (discovers the case's raw "
                        "u VTK + probe CSVs) or a .vtk file directly")
    parser.add_argument("--output-dir", help="where figures/CSVs go "
                        "(default RESULTS/figures next to the deck, or the "
                        "VTK's directory)")
    parser.add_argument("--height-interval", type=float, default=50.0,
                        metavar="M", help="layer ladder spacing in meters")
    parser.add_argument("--height-start", type=float, default=None,
                        metavar="M", help="first ladder height in meters")
    parser.add_argument("--quick-test", action="store_true",
                        help="small validation pass: few heights, "
                             "truncated 3-D subvolume")
    parser.add_argument("--test-height-count", type=int, default=3)
    parser.add_argument("--test-3d-layers", type=int, default=24)
    args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))

    target = Path(args.target).expanduser().resolve()
    if target.suffix.lower() == ".vtk":
        vtk_files = [target]
        home = target.parent
        fig_dir = Path(args.output_dir) if args.output_dir else home
    else:
        deck = load_deck(target)
        dt_tag = deck.get_text("datetime") or ""
        home = target.parent
        fig_dir = (Path(args.output_dir) if args.output_dir
                   else home / "RESULTS" / "figures")
        vtk_files = [f for f in discover_case_vtk_files(home, dt_tag)
                     if "_raw_u-" in f.name][-1:]
    fig_dir.mkdir(parents=True, exist_ok=True)
    wrote = 0

    max_heights = args.test_height_count if args.quick_test else None
    quick_layers = args.test_3d_layers if args.quick_test else None
    for vtk in vtk_files:
        try:
            arts = isotropic_report(vtk, fig_dir, quick_layers=quick_layers)
        except RuntimeError as e:
            print(f"luwspectra: 3-D spectrum skipped: {e}")
            arts = []
        arts += horizontal_layer_report(
            vtk, fig_dir, dz_target=args.height_interval,
            start_m=args.height_start, max_heights=max_heights)
        for p in arts:
            print(f"luwspectra: wrote {p.name}")
            wrote += 1

    # probe CSV time-series spectra (RESULTS/<lon>_<lat>*.csv contract)
    for probe_csv in sorted((home / "RESULTS").glob("*.csv")):
        try:
            lines = probe_csv.read_text().splitlines()
            if not lines or not lines[0].startswith("height"):
                continue
            times = np.asarray([float(v) for v in lines[0].split(",")[1:]])
            if len(times) < 8:
                continue
            row = lines[len(lines) // 2].split(",")
            u_series = np.asarray([float(c.split(":")[0]) for c in row[1:]])
            sp = spectrum_from_series(u_series, float(np.diff(times).mean()))
            if sp is None:
                continue
            freq, E = sp
            out = loglog_figure(
                fig_dir / f"{probe_csv.stem}_spectrum.png", freq, E, freq,
                title=f"probe {probe_csv.stem} @ {row[0]} m; dashed f^-5/3; "
                      "x f (Hz), y E(f)")
            print(f"luwspectra: wrote {out.name}")
            wrote += 1
        except (ValueError, IndexError):
            continue
    if not wrote:
        print("luwspectra: no inputs found (need raw u VTK or probe CSVs)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
