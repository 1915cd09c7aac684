"""PyTorch port, WRF NetCDF ingestion and buildBC (`pre/wrf_ingest.py`,
`pre/buildbc.py`) against the JAX package.

The five cases of `tests/test_wrf_ingest.py` on its synthetic WRF file
(`_write_wrf_nc3`, imported from there) run through both packages, each in
a case directory of its own: the SurfData CSVs are byte for byte equal and
the decks' writebacks equal, and each case's own assertions hold on the
port's output.  Both packages are the same numpy code: nothing here has a
tolerance.
"""

import math
import warnings
from pathlib import Path

import numpy as np
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from tests.test_wrf_ingest import _write_wrf_nc3

CSV = "proj_temp/SurfData_20251010120000.csv"


def _both(tmp_path: Path, deck_text: str, *, dem=False):
    """Run luwbc of both packages on the same case; return the port's case
    directory after holding the CSV and the deck to the JAX package's."""
    from latticeurbanwind_tpu.pre.buildbc import main as jax_bc
    from latticeurbanwind_tpu.pre.shp_reader import write_point_shp
    from latticeurbanwind_tpu_torch.pre.buildbc import main as port_bc

    cases = {}
    for side, bc in (("jax", jax_bc), ("port", port_bc)):
        case = tmp_path / side
        (case / "wind_bc").mkdir(parents=True)
        (case / "conf.luw").write_text(deck_text)
        _write_wrf_nc3(case / "wind_bc" / "nwp_20251010120000.nc")
        if dem:
            (case / "terrain_db").mkdir()
            lon = 121.3 + 0.01 * np.arange(9)
            lat = 31.1 + 0.01 * np.arange(8)
            pts = [(lo, la) for la in lat for lo in lon]
            elevs = [60.0 * (lo - lon[0]) / (lon[-1] - lon[0]) for lo, _ in pts]
            write_point_shp(case / "terrain_db" / "dem.shp", pts, values=elevs)
        assert bc([str(case / "conf.luw")]) == 0
        cases[side] = case
    assert (cases["jax"] / CSV).read_bytes() == (cases["port"] / CSV).read_bytes()
    assert (cases["jax"] / "conf.luw").read_text() == \
        (cases["port"] / "conf.luw").read_text()
    return cases["port"]


def test_luwbc_wrf_nc3_ingest(tmp_path):
    from latticeurbanwind_tpu_torch.deck import load_deck

    case = _both(tmp_path, "// LUW deck\ncasename = nwp\n"
                 "datetime = 20251010120000\nbase_height = 20.0\nz_limit = 200\n")
    with open(case / CSV) as fh:
        header = fh.readline().strip().split(",")
    assert header[:6] == ["X", "Y", "Z", "u", "v", "w"]
    data = np.loadtxt(case / CSV, delimiter=",", skiprows=1)
    assert len(data) > 100 and np.isfinite(data).all()
    speed = np.hypot(data[:, 3], data[:, 4])
    assert 3.0 < speed.max() < 12.0
    assert data[:, 2].min() >= 0.0
    deck = load_deck(case / "conf.luw")
    for key in ("si_x_cfd", "si_y_cfd", "si_z_cfd"):
        rng = deck.get_float_list(key)
        assert rng and len(rng) == 2 and rng[1] > rng[0]
    assert deck.get_text("downstream_bc")


def test_load_nc_vars_copies_out_of_the_map(tmp_path):
    """The scipy loader closes its file without the mmap warning, and the
    arrays it returns equal the JAX loader's."""
    from latticeurbanwind_tpu.pre.wrf_ingest import load_nc_vars as jax_load
    from latticeurbanwind_tpu_torch.pre.wrf_ingest import load_nc_vars

    path = tmp_path / "w.nc"
    _write_wrf_nc3(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = load_nc_vars(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_load(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k][0] == ref[k][0]
        np.testing.assert_array_equal(got[k][1], ref[k][1])
        arr = got[k][1]        # a copy: it or its base owns its memory
        assert arr.flags.owndata or arr.base.flags.owndata


def test_buildbc_patch_faces_and_rotation(tmp_path):
    from latticeurbanwind_tpu_torch.deck import load_deck

    case = _both(tmp_path, "// LUW deck\ncasename = nwp\n"
                 "datetime = 20251010120000\nbase_height = 20.0\nz_limit = 200\n"
                 "midmesh_basesize = 50\ncut_lon_manual = [121.31, 121.36]\n"
                 "cut_lat_manual = [31.11, 31.16]\n")
    with open(case / CSV) as fh:
        header = fh.readline().strip().split(",")
    assert header[-1] == "patch"
    data = np.loadtxt(case / CSV, delimiter=",", skiprows=1)
    patch = data[:, -1].astype(int)
    assert set(patch) == {0, 1, 2, 3, 4, 5}
    z, w = data[:, 2], data[:, 5]
    assert np.allclose(z[patch == 0], z[patch == 0].min(), atol=0.2)
    assert np.allclose(z[patch == 1], z.max())
    assert np.all(w[patch == 1] == 0.0)
    for p in (2, 3, 4, 5):
        assert z[patch == p].min() <= z[patch == 0].min() + 0.2
        assert np.all(w[patch == p] == 0.0)
    deck = load_deck(case / "conf.luw")
    assert abs(deck.get_float("rotate_deg")) < 2.0
    assert deck.get_text("downstream_bc") == "+x"
    um = deck.get_float_list("um_vol")
    expect = math.degrees(math.atan2(abs(um[1]), abs(um[0])))
    assert abs(deck.get_float("downstream_bc_yaw") - expect) < 0.5
    assert deck.get_float_list("um_bc")


def test_buildbc_dem_terrain_sampling(tmp_path):
    from latticeurbanwind_tpu_torch.deck import load_deck

    case = _both(tmp_path, "// LUW deck\ncasename = nwp\n"
                 "datetime = 20251010120000\nbase_height = 20.0\nz_limit = 200\n"
                 "midmesh_basesize = 50\n", dem=True)
    data = np.loadtxt(case / CSV, delimiter=",", skiprows=1)
    zb = data[data[:, -1].astype(int) == 0, 2]
    assert zb.max() - zb.min() > 40.0
    assert load_deck(case / "conf.luw").get_float_list("si_z_cfd")[1] > 260.0


def test_buildbc_rotation_consistency_with_transform(tmp_path):
    from latticeurbanwind_tpu.pre.buildbc import build_structured as jax_build
    from latticeurbanwind_tpu_torch.deck import load_deck, parse_deck_text
    from latticeurbanwind_tpu_torch.post.transform import TransformModel
    from latticeurbanwind_tpu_torch.pre.buildbc import build_structured

    ny, nx = 8, 9
    lon, lat = np.meshgrid(np.linspace(16.95, 17.25, nx),
                           np.linspace(58.97, 59.13, ny))
    z = np.array([10.0, 50.0, 100.0, 150.0, 220.0])
    shape3 = (len(z), ny, nx)
    cases = {}
    for side, build in (("jax", jax_build), ("port", build_structured)):
        case = tmp_path / side
        (case / "proj_temp").mkdir(parents=True)
        parse_deck_text(
            "// LUW deck\ncasename = t\ndatetime = 20250101000000\n"
            "base_height = 20\nz_limit = 200\nmidmesh_basesize = 100\n"
            "cut_lon_manual = [17.00, 17.20]\ncut_lat_manual = [59.00, 59.10]\n"
        ).save(case / "conf.luw")
        build(case / "conf.luw", lon, lat, z, np.full(shape3, 5.0),
              np.full(shape3, 2.0), np.zeros(shape3))
        cases[side] = case
    csv = "proj_temp/SurfData_20250101000000.csv"
    assert (cases["jax"] / csv).read_bytes() == (cases["port"] / csv).read_bytes()
    assert (cases["jax"] / "conf.luw").read_text() == \
        (cases["port"] / "conf.luw").read_text()

    deck = load_deck(cases["port"] / "conf.luw")
    assert abs(deck.get_float("rotate_deg")) > 0.5
    tm = TransformModel.from_deck(deck)
    x0, y0 = tm.lonlat_to_local(np.array([17.00]), np.array([59.00]))
    assert abs(float(x0[0])) < 1e-6 and abs(float(y0[0])) < 1e-6
    lo, la = tm.local_to_lonlat(np.array([1234.5]), np.array([987.6]))
    xb, yb = tm.lonlat_to_local(lo, la)
    assert abs(float(xb[0]) - 1234.5) < 1e-3 and abs(float(yb[0]) - 987.6) < 1e-3
    data = np.loadtxt(cases["port"] / csv, delimiter=",", skiprows=1)
    ue, vn = tm.derotate_winds(data[:, 3], data[:, 4])
    assert np.allclose(ue, 5.0, atol=1e-3) and np.allclose(vn, 2.0, atol=1e-3)


def test_buildbc_vectorized_sampler_matches_scalar_rule():
    from latticeurbanwind_tpu.pre.buildbc import _idw_interp_1d as jax_rule
    from latticeurbanwind_tpu_torch.pre.buildbc import _idw_interp_1d

    rng = np.random.default_rng(0)
    nz, dz = 9, 25.0
    z_new = np.arange(nz) * dz
    col = rng.standard_normal(nz)
    zq = np.concatenate([rng.uniform(0, (nz - 1) * dz, 200),
                         z_new, [0.0, (nz - 1) * dz]])
    k_lo = np.clip((zq // dz).astype(np.int64), 0, nz - 2)
    d_lo = zq - k_lo * dz
    d_up = (k_lo + 1) * dz - zq
    w_lo = 1.0 / np.maximum(d_lo, 1e-12)
    w_up = 1.0 / np.maximum(d_up, 1e-12)
    snap_lo = d_lo < 1e-6
    snap_up = (d_up < 1e-6) & ~snap_lo
    w_lo = np.where(snap_lo, 1.0, np.where(snap_up, 0.0, w_lo))
    w_up = np.where(snap_lo, 0.0, np.where(snap_up, 1.0, w_up))
    vec = (w_lo * col[k_lo] + w_up * col[k_lo + 1]) / (w_lo + w_up)
    ref = np.array([_idw_interp_1d(col, float(q), z_new) for q in zq])
    np.testing.assert_allclose(vec, ref, atol=1e-9)
    np.testing.assert_array_equal(
        ref, [jax_rule(col, float(q), z_new) for q in zq])
