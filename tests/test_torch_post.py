"""PyTorch port, the post-processing tools against the JAX package: visluw,
luwutmnc (`vtk_avg_to_utm_asl_nc`), luwcutvis (`cut_vis`), luwseason
(`season_average`), luwspectra (`les_spectra`) and luwtkeviz (`tke_viz`).

The same seeded case goes through both packages' functions, each in a
directory of its own.  Files are held byte for byte (NetCDF, VTK, CSV and
summary text); the spectra CSVs within 1e-12 relative.  The port draws its
figures through `io/figure.py` and the JAX package through matplotlib, so
figures are held by their names, their count and the layers they show:
each matplotlib title the JAX package sets (its `savefig` is replaced by
a stub that writes an empty file, which keeps these tests fast) stands in
the port's PNG text chunk, and every port PNG reads back through
`png_size`.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from latticeurbanwind_tpu.io.vtk import (read_structured_points,
                                         write_structured_points)
from latticeurbanwind_tpu_torch.io.png import png_size

SIDES = ("jax", "port")


def png_text(path: Path) -> str:
    """The PNG's `tEXt` Title."""
    raw = Path(path).read_bytes()
    pos = 8
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        if kind == b"tEXt" and data.startswith(b"Title\x00"):
            return data[6:].decode("latin-1")
        pos += 12 + n
    return ""


@pytest.fixture
def mpl_figures(monkeypatch):
    """{file name: [axes titles]} of every figure the JAX package saves;
    its savefig writes an empty file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.axes
    import matplotlib.figure

    saved, titles = {}, []
    real = matplotlib.axes.Axes.set_title

    def set_title(self, label, *a, **k):
        titles.append(label)
        return real(self, label, *a, **k)

    def savefig(self, fname, *a, **k):
        Path(fname).write_bytes(b"")
        saved[Path(fname).name] = list(titles)
        titles.clear()

    monkeypatch.setattr(matplotlib.axes.Axes, "set_title", set_title)
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return saved


def hold_figures(port_pngs, saved: dict) -> None:
    """The port's PNGs are the JAX package's by name; each reads back and
    carries the JAX figure's axes titles in its text chunk."""
    port_pngs = sorted(Path(p) for p in port_pngs)
    assert [p.name for p in port_pngs] == sorted(saved)
    for p in port_pngs:
        w, h = png_size(p)
        assert w > 0 and h > 0
        assert set(saved[p.name]) <= set(png_text(p).split("; ")), p.name


def same_bytes(a: Path, b: Path) -> None:
    assert a.read_bytes() == b.read_bytes(), (a.name, b.name)


def tiny_avg_case(root: Path, with_geo=True):
    """`tests/test_pre_post_tools.py::_tiny_avg_case` in `root`: a deck and
    one avg VTK with u_avg/rho_avg/tke/fluid fields."""
    from latticeurbanwind_tpu.deck import parse_deck_text

    home = root / "case"
    (home / "RESULTS" / "vtk").mkdir(parents=True)
    text = ("// LUW deck\ncasename = t\ndatetime = 20250101000000\n"
            "base_height = 20\n")
    if with_geo:
        text += ("cut_lon_manual = [121.30, 121.34]\n"
                 "cut_lat_manual = [31.10, 31.13]\n"
                 'utm_crs = "EPSG:32651"\nrotate_deg = 0.5\n')
    parse_deck_text(text).save(home / "conf.luw")
    nz, ny, nx = 6, 20, 24
    rng = np.random.default_rng(0)
    fields = {
        "u_avg": rng.uniform(1, 5, (3, nz, ny, nx)).astype(np.float32),
        "rho_avg": np.full((nz, ny, nx), 1.2, np.float32),
        "tke": rng.uniform(0, 1, (nz, ny, nx)).astype(np.float32),
        "fluid": np.ones((nz, ny, nx), np.float32),
    }
    vtk = home / "RESULTS" / "vtk" / "ANG_0_20250101000000_avg-000000100.vtk"
    write_structured_points(vtk, fields, spacing=10.0)
    return home, vtk, fields


def cases(tmp_path, with_geo=True):
    return {s: tiny_avg_case(tmp_path / s, with_geo) for s in SIDES}


# ---- visluw ------------------------------------------------------------------

def test_visluw_netcdf_and_layers(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.post import visluw as J
    from latticeurbanwind_tpu_torch.post import visluw as T

    c = cases(tmp_path)
    out = {}
    for s, mod in zip(SIDES, (J, T)):
        home, vtk, _ = c[s]
        out[s] = mod.render_layers(home / "conf.luw", vtk, sections=3, write_nc=True)
    assert [p.name for p in out["jax"]] == [p.name for p in out["port"]]
    same_bytes(out["jax"][-1], out["port"][-1])
    assert out["port"][-1].name == c["port"][1].stem + "_visluw.nc"
    hold_figures(out["port"][:-1], mpl_figures)

    _, fields = read_structured_points(c["port"][1])
    for name in ("U", "data"):
        vec = {name: fields["u_avg"], "tke": fields["tke"]}
        assert J.pick_vector_field(vec)[0] == T.pick_vector_field(vec)[0]
    for kw in (dict(sections=9), dict(sections=3), dict(heights=[12.0, 32.0]),
               dict(heights=[0.0, 0.0, 500.0])):
        for args in ((6, 10.0, -30.0, 20.0), (40, 2.0, 0.0, 16.0), (5, 8.0, 0.0, 90.0)):
            assert T.select_layers(*args, **kw) == J.select_layers(*args, **kw)


def test_visluw_height_selection(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.post.visluw import render_layers as jax_render
    from latticeurbanwind_tpu_torch.post.visluw import render_layers

    c = cases(tmp_path, with_geo=False)
    names = {}
    for s, fn in zip(SIDES, (jax_render, render_layers)):
        home, vtk, _ = c[s]
        names[s] = sorted(p.name for p in fn(home / "conf.luw", vtk,
                                             heights=[12.0, 32.0], write_nc=False))
    assert names["port"] == names["jax"] == ["wind_15m.png", "wind_35m.png"]


def test_visluw_cli_crop_and_outputs(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.post.visluw import main as jax_main
    from latticeurbanwind_tpu_torch.post.visluw import main

    c = cases(tmp_path)
    for s, fn in zip(SIDES, (jax_main, main)):
        home = c[s][0]
        assert fn([str(home / "conf.luw"), "--layers", "2",
                   "--lon-min", "121.3005", "--lon-max", "121.3018",
                   "--lat-min", "31.0999", "--lat-max", "31.1012",
                   "--output-dir", str(tmp_path / s / "figs"),
                   "--nc-output", str(tmp_path / s / "crop.nc")]) == 0
        assert fn([str(home / "conf.luw"), "--lon-min", "121.3005"]) == 2
    same_bytes(tmp_path / "jax" / "crop.nc", tmp_path / "port" / "crop.nc")
    hold_figures((tmp_path / "port" / "figs").glob("*.png"), mpl_figures)


# ---- luwutmnc ----------------------------------------------------------------

def test_utmnc_single_deck_and_asl(tmp_path):
    from latticeurbanwind_tpu.post import vtk_avg_to_utm_asl_nc as J
    from latticeurbanwind_tpu_torch.post import vtk_avg_to_utm_asl_nc as T

    c = cases(tmp_path)
    rng_file = tmp_path / "Range.txt"
    rng_file.write_text("case:\n  terrain_min_asl_m = 120.5\n")
    for s, mod in zip(SIDES, (J, T)):
        home = c[s][0]
        assert mod.main([str(home / "conf.luw"), "--range-file", str(rng_file),
                         "--pedestal-height", "20", "--overwrite"]) == 0
        assert mod.main([str(home / "conf.luw"), "--terrain-min-asl", "120.5",
                         "--pedestal-height", "20"]) == 1      # skipped existing
    name = c["port"][1].stem + "_utm_asl.nc"
    same_bytes(*(c[s][0] / "RESULTS" / "nc_utm_asl" / name for s in SIDES))
    alt = tmp_path / "alt.txt"
    alt.write_text("the beijing domain sits at 43 m\nshanghai:\n  5 m\n"
                   "rome:\n  terrain_min_asl_m = -2.5\n")
    for want in (["beijing", "shanghai"], ["rome"], None):
        assert T.parse_range_asl(alt, want) == J.parse_range_asl(alt, want)


def test_utmnc_multicase_batch(tmp_path):
    from latticeurbanwind_tpu.post.vtk_avg_to_utm_asl_nc import main as jax_main
    from latticeurbanwind_tpu_torch.post.vtk_avg_to_utm_asl_nc import main

    rng_file = tmp_path / "Range.txt"
    rng_file.write_text("alpha: 10 m\nbeta: 20 m\n")
    for s, fn in zip(SIDES, (jax_main, main)):
        root = tmp_path / s / "fleet"
        for name in ("alpha", "beta"):
            case = root / name
            tiny_avg_case(case)
            for p in (case / "case").iterdir():
                p.rename(case / p.name)
            (case / "case").rmdir()
        assert fn([str(root), "--cases", "alpha", "beta", "--range-file",
                   str(rng_file), "--limit", "1", "--overwrite"]) == 0
    for name in ("alpha", "beta"):
        ncs = [sorted((tmp_path / s / "fleet" / name / "RESULTS" / "nc_utm_asl")
                      .glob("*.nc")) for s in SIDES]
        assert len(ncs[0]) == len(ncs[1]) == 1
        same_bytes(ncs[0][0], ncs[1][0])


# ---- luwcutvis ---------------------------------------------------------------

def test_cutvis_geo_crop_outputs(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.deck import load_deck
    from latticeurbanwind_tpu.post import cut_vis as J
    from latticeurbanwind_tpu_torch.post import cut_vis as T

    c = cases(tmp_path)
    for s, mod in zip(SIDES, (J, T)):
        home = c[s][0]
        deck = load_deck(home / "conf.luw")
        deck.set_float("crop_min_lon", 121.3195)
        deck.set_float("crop_max_lon", 121.3205)
        deck.set_float("crop_min_lat", 31.11470)
        deck.set_float("crop_max_lat", 31.11530)
        deck.set_float("crop_vis_dpi", 60)
        deck.save()
        assert mod.main([str(home / "conf.luw")]) == 0
    cropped = [c[s][1].with_name(c[s][1].stem + "_cropped.vtk") for s in SIDES]
    same_bytes(*cropped)
    hold_figures((c["port"][0] / "RESULTS" / "figures").glob("*.png"), mpl_figures)
    assert {"wind9", "tke9"} <= {p.stem.rsplit("_", 1)[1] for p in
                                 (c["port"][0] / "RESULTS" / "figures").glob("*.png")}
    from latticeurbanwind_tpu_torch.deck import load_deck as port_load_deck

    meta, _ = read_structured_points(c["port"][1])
    deck = c["port"][0] / "conf.luw"
    assert T.geo_crop_bounds(port_load_deck(deck), meta) == \
        J.geo_crop_bounds(load_deck(deck), meta)
    for nz in (2, 6, 9, 10, 50, 118):
        assert T.nine_layers(nz) == sorted(set(np.linspace(1, nz - 1, 9, dtype=int)))


def test_cutvis_cli_option_surface(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.post.cut_vis import main as jax_main
    from latticeurbanwind_tpu_torch.post.cut_vis import main

    c = cases(tmp_path)
    for s, fn in zip(SIDES, (jax_main, main)):
        home, vtk, _ = c[s]
        figdir = tmp_path / s / "figs"
        assert fn([str(home / "conf.luw"), "--min-x", "40", "--max-x", "160",
                   "--min-y", "30", "--max-y", "130", "--dpi", "50",
                   "--quiver-step", "3", "--output-dir", str(figdir)]) == 0
        cropped = vtk.with_name(vtk.stem + "_cropped.vtk")
        (tmp_path / s / "first.vtk").write_bytes(cropped.read_bytes())
        cropped.unlink()
        assert fn([str(home / "conf.luw"), "20", "180", "20", "160",
                   "--no-cropped-vtk", "--dpi", "50",
                   "--output-dir", str(figdir)]) == 0
        assert not cropped.exists()
    same_bytes(tmp_path / "jax" / "first.vtk", tmp_path / "port" / "first.vtk")
    hold_figures((tmp_path / "port" / "figs").glob("*.png"), mpl_figures)


# ---- luwseason ---------------------------------------------------------------

def test_season_windrose_weight_derivation(tmp_path):
    from latticeurbanwind_tpu.post import season_average as J
    from latticeurbanwind_tpu_torch.post import season_average as T

    home = tmp_path / "case"
    (home / "wind_bc").mkdir(parents=True)
    (home / "wind_bc" / "profile.dat").write_text(
        "z,U\n1\t0.5\n10\t5.0\n100\t50.0\n")
    (home / "wind_bc" / "windrose_10m.csv").write_text(
        "title row\ndir,C1_0_4,C2_4p5_8,C3_8_inf\nN,10,30,1\nE,40,20,-\n"
        "157.5,1,2,3\nWNW,0.5,0.5,na\n")
    rose = home / "wind_bc" / "windrose_10m.csv"
    tj, tabj, totj = J.parse_windrose_csv(rose)
    tt, tabt, tott = T.parse_windrose_csv(rose)
    np.testing.assert_array_equal(tt, tj)
    assert tott == totj and tabt.keys() == tabj.keys()
    for a in tabj:
        np.testing.assert_array_equal(tabt[a], tabj[a])
    assert T.derive_direction_weights(home) == J.derive_direction_weights(home)
    assert T.parse_windrose_height(rose) == J.parse_windrose_height(rose) == 10.0


def _directional_avgs(vtk_dir: Path, dt: str, angles, shape, seed=0):
    """One seeded avg VTK per angle (u_avg, tke, fluid) and an older,
    lower-step file per angle that must be ignored."""
    rng = np.random.default_rng(seed)
    Z, Y, X = shape
    fluid = np.ones(shape, np.float32)
    fluid[:2, 2:4, 3:5] = 0.0
    for a in angles:
        f = {"u_avg": rng.normal(2.0, 1.0, (3, Z, Y, X)).astype(np.float32),
             "tke": rng.uniform(0.1, 1.0, shape).astype(np.float32),
             "fluid": fluid}
        write_structured_points(vtk_dir / f"ANG_{a:g}_{dt}_avg-000000005.vtk",
                                {k: v * 100 for k, v in f.items()}, spacing=5.0)
        write_structured_points(vtk_dir / f"ANG_{a:g}_{dt}_avg-000000050.vtk",
                                f, spacing=5.0)


def test_season_synthesize_full_surface(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.post.season_average import main as jax_main
    from latticeurbanwind_tpu_torch.post.season_average import main

    for s, fn in zip(SIDES, (jax_main, main)):
        home = tmp_path / s
        vtk_dir = home / "RESULTS" / "vtk"
        vtk_dir.mkdir(parents=True)
        (home / "conf.luwpf").write_text(
            "// Project\ncasename = demo\ndatetime = 20260101\n")
        _directional_avgs(vtk_dir, "20260101", (0.0, 90.0), (6, 10, 12))
        (home / "w.csv").write_text("angle,weight,scale\n0,1,1.2\n90,3,0.9\n45,1\n")
        assert fn([str(home / "conf.luwpf"), str(home / "w.csv"),
                   "--output-spacing", "2.5", "3", "4", "--dpi", "50"]) == 0
        (home / "RESULTS" / "first.vtk").write_bytes(
            (vtk_dir / "SEASON_20260101_avg.vtk").read_bytes())
        alt = home / "alt_vtk"
        alt.mkdir()
        for f in vtk_dir.glob("ANG_*.vtk"):
            (alt / f.name).write_bytes(f.read_bytes())
        assert fn([str(home / "conf.luwpf"), str(home / "w.csv"), "2",
                   "--vtk-dir", "alt_vtk", "--skip-figures"]) == 0
    for rel in ("RESULTS/first.vtk", "RESULTS/vtk/SEASON_20260101_avg.vtk",
                "RESULTS/season_summary.txt"):
        same_bytes(tmp_path / "jax" / rel, tmp_path / "port" / rel)
    hold_figures((tmp_path / "port" / "RESULTS" / "figures").glob("*.png"),
                 mpl_figures)


def test_season_derived_windrose(tmp_path, mpl_figures):
    """The DG example's last step on synthetic 16-direction averages: the
    weights derived from a windrose + profile.dat; the season VTK, the
    weights CSV and the summary byte for byte, and u_avg the weighted sum
    of the directional fields."""
    from latticeurbanwind_tpu.post.season_average import main as jax_main
    from latticeurbanwind_tpu_torch.post.season_average import (
        ANGLE_SEQUENCE, COMPASS, main)

    probs = np.array([2, 2, 3, 3, 4, 5, 6, 8, 10, 14, 16, 11, 7, 4, 3, 2], float)
    probs *= 100.0 / probs.sum()
    dt = "20260101120000"
    for s, fn in zip(SIDES, (jax_main, main)):
        home = tmp_path / s
        vtk_dir = home / "RESULTS" / "vtk"
        vtk_dir.mkdir(parents=True)
        (home / "conf.luwdg").write_text(f"casename = rose\ndatetime = {dt}\n")
        _directional_avgs(vtk_dir, dt, ANGLE_SEQUENCE, (4, 6, 8), seed=1)
        (home / "wind_bc").mkdir()
        (home / "wind_bc" / "profile.dat").write_text(
            "z,U\n1\t3.0\n10\t6.0\n100\t9.0\n")
        rows = ["dir,C1_0_4,C2_4_8,C3_8_inf"] + [
            f"{c},{0.2 * p:.6f},{0.5 * p:.6f},{0.3 * p:.6f}"
            for c, p in zip(COMPASS, probs)]
        (home / "wind_bc" / "windrose_10m.csv").write_text("\n".join(rows) + "\n")
        assert fn([str(home / "conf.luwdg"), "--dpi", "40"]) == 0
    for rel in (f"RESULTS/vtk/SEASON_{dt}_avg.vtk", "RESULTS/season_weights.csv",
                "RESULTS/season_summary.txt"):
        same_bytes(tmp_path / "jax" / rel, tmp_path / "port" / rel)
    hold_figures((tmp_path / "port" / "RESULTS" / "figures").glob("*.png"),
                 mpl_figures)
    home = tmp_path / "port"
    weights = np.loadtxt(home / "RESULTS" / "season_weights.csv", delimiter=",",
                         skiprows=1)
    want = sum(vw * read_structured_points(
        home / "RESULTS" / "vtk" / f"ANG_{a:g}_{dt}_avg-000000050.vtk")[1]["u_avg"]
        .astype(np.float64) for a, vw, _, _ in weights)
    _, season = read_structured_points(home / "RESULTS" / "vtk" / f"SEASON_{dt}_avg.vtk")
    np.testing.assert_allclose(season["u_avg"], want, atol=1e-5, rtol=0)


# ---- luwspectra --------------------------------------------------------------

def test_les_spectra_horizontal_layers(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.post import les_spectra as J
    from latticeurbanwind_tpu_torch.post import les_spectra as T

    c = cases(tmp_path, with_geo=False)
    out = {}
    for s, mod in zip(SIDES, (J, T)):
        home, vtk, _ = c[s]
        fig_dir = home / "RESULTS" / "figures"
        fig_dir.mkdir(parents=True)
        out[s] = mod.horizontal_layer_report(vtk, fig_dir, dz_target=20.0)
    assert [p.name for p in out["port"]] == [p.name for p in out["jax"]]
    same_bytes(out["jax"][-1], out["port"][-1])          # the layers CSV
    hold_figures(out["port"][:-1], mpl_figures)

    rng = np.random.default_rng(5)
    lay = rng.normal(size=(24, 30))
    for a, b in zip(T.horizontal_spectrum(lay, 2.0), J.horizontal_spectrum(lay, 2.0)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    arrs = [rng.uniform(0, 1, (8, 8)) ** 6, np.zeros((3, 3))]
    assert T.robust_log_limits(arrs) == J.robust_log_limits(arrs)
    for mod in (T, J):                   # no positive value: both refuse
        with pytest.raises(ValueError):
            mod.robust_log_limits([np.zeros(4)])
    for args in ((10, 10.0, 0.0, 30.0), (40, 2.0, -37.0, 7.0), (5, 3.0, 0.0, 50.0, 4.0)):
        assert T.layer_ladder(*args) == J.layer_ladder(*args)


def _close_csv(a: Path, b: Path, rtol=1e-12) -> None:
    la, lb = a.read_text().splitlines(), b.read_text().splitlines()
    assert la[0] == lb[0] and len(la) == len(lb)
    np.testing.assert_allclose(
        np.array([[float(v) for v in r.split(",")] for r in la[1:]]),
        np.array([[float(v) for v in r.split(",")] for r in lb[1:]]),
        rtol=rtol, atol=0)


def test_les_spectra_cli_surface(tmp_path, mpl_figures):
    from latticeurbanwind_tpu.post import les_spectra as J
    from latticeurbanwind_tpu_torch.post import les_spectra as T

    rng = np.random.default_rng(3)
    Z, Y, X = 16, 24, 24
    u = rng.normal(2.0, 0.4, (3, Z, Y, X)).astype(np.float32)
    fluid = np.ones((Z, Y, X), np.float32)
    fluid[:4, 5:9, 5:9] = 0.0
    times = np.arange(64) * 0.5
    series = 2.0 + np.sin(times) + 0.1 * rng.normal(size=len(times))
    probe = ("height," + ",".join(f"{t:g}" for t in times) + "\n"
             + "\n".join(f"{h}," + ",".join(f"{v * h / 10:.5f}:0.1:0.0" for v in series)
                         for h in (2, 10, 30)) + "\n")
    for s, mod in zip(SIDES, (J, T)):
        vtk = tmp_path / s / "demo_raw_u-000000100.vtk"
        (tmp_path / s / "RESULTS").mkdir(parents=True)
        (tmp_path / s / "RESULTS" / "121.1_31.2.csv").write_text(probe)
        write_structured_points(vtk, {"u": u, "fluid": fluid}, spacing=10.0)
        assert mod.main([str(vtk), "--output-dir", str(tmp_path / s / "figs"),
                         "--height-interval", "40", "--height-start", "0",
                         "--quick-test", "--test-height-count", "2"]) == 0
    figs = [tmp_path / s / "figs" for s in SIDES]
    assert sorted(p.name for p in figs[0].iterdir()) == \
        sorted(p.name for p in figs[1].iterdir())
    _close_csv(figs[0] / "demo_raw_u-000000100_Ek.csv",
               figs[1] / "demo_raw_u-000000100_Ek.csv")
    same_bytes(figs[0] / "demo_raw_u-000000100_kxky_layers.csv",
               figs[1] / "demo_raw_u-000000100_kxky_layers.csv")
    hold_figures(figs[1].glob("*.png"), mpl_figures)

    assert T.full_coverage_z_start(fluid) == J.full_coverage_z_start(fluid) == 4
    for a, b in zip(T.spectrum_3d(u, 10.0), J.spectrum_3d(u, 10.0)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for a, b in zip(T.spectrum_3d(u[0, :, :, :23], 7.0, nbins=17),
                    J.spectrum_3d(u[0, :, :, :23], 7.0, nbins=17)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for a, b in zip(T.spectrum_from_series(series, 0.5),
                    J.spectrum_from_series(series, 0.5)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    assert T.spectrum_from_series(series[:7], 0.5) is None


# ---- luwtkeviz ---------------------------------------------------------------

def test_luwtkeviz(tmp_path, mpl_figures, capsys):
    from latticeurbanwind_tpu.post import tke_viz as J
    from latticeurbanwind_tpu_torch.post import tke_viz as T

    Z, Y, X = 12, 24, 32
    rng = np.random.default_rng(0)
    u = rng.normal(3.0, 0.5, (3, Z, Y, X)).astype(np.float32)
    tke = np.abs(rng.normal(0.2, 0.05, (Z, Y, X))).astype(np.float32)
    for s, mod in zip(SIDES, (J, T)):
        vtk = tmp_path / s / "case_avg-000000100.vtk"
        write_structured_points(vtk, {"u_avg": u, "tke": tke}, spacing=10.0)
        assert mod.main([str(vtk), "--out", str(tmp_path / s / "viz"),
                         "--base-height", "0", "--layer-step", "10",
                         "--heights", "15", "35", "55", "75", "95"]) == 0
        case = tmp_path / s / "case"
        (case / "RESULTS" / "vtk").mkdir(parents=True)
        write_structured_points(case / "RESULTS" / "vtk" / "x_avg-000000050.vtk",
                                {"data": u}, spacing=10.0)
        (case / "conf.luw").write_text("casename = x\n")
        assert mod.main(["--deck", str(case / "conf.luw"), "--base-height", "0"]) == 0
        assert mod.main([]) == 2
    for sub in ("viz", "case/RESULTS/tke_viz"):
        assert sorted(p.name for p in (tmp_path / "jax" / sub).glob("*.png")) == \
            sorted(p.name for p in (tmp_path / "port" / sub).glob("*.png"))
    hold_figures([*(tmp_path / "port" / "viz").glob("*.png")], {
        k: v for k, v in mpl_figures.items() if k.startswith("case_avg")})
    for args in ((12, [15, 35, 55, 75, 95], 0.0, 10.0),
                 (30, T.TARGET_HEIGHTS_M, -50.0, 10.0), (5, [1, 2, 300], 0.0, 3.0)):
        assert T._layers(*args) == J._layers(*args)
