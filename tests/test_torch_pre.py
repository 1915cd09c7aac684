"""PyTorch port, the pre-processing stages (`pre/shp_reader.py`,
`pre/shpcutter.py`, `pre/dem_ingest.py`, `pre/terrain.py`,
`pre/voxelization.py`, `cli/validate.py`, `cli/clean.py`,
`cli/inspect_tools.py`) against the JAX package on the same seeded inputs.

Tolerances: every stage but the `kriging_gpu` solve is the same numpy code,
so its files are held byte for byte and its arrays bit for bit.  The
`kriging_gpu` solve is float32 in both packages (`jnp.linalg.solve` there,
`torch.linalg.solve_ex` here, different LU codes): the interpolated
elevations agree within 1e-3 m on a 100 m hill, against a float32-vs-float64
gap of the JAX solve of about 5e-5 m.  The even-odd point-in-ring test is
held to `matplotlib.path.Path.contains_points` away from the ring's edges
(points within 1e-9 of an edge are left out: matplotlib leaves them
undefined).
"""

import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PREPARED = REPO / "examples" / "example_NWP-LBM_prepared"
CUT_LON = (121.308, 121.340)
CUT_LAT = (31.108, 31.132)


def _files_equal(a: Path, b: Path, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def random_ring(rng, cx, cy, r, n, star=True):
    """A ring of n vertices around (cx, cy): star-shaped (sorted angles,
    jittered radius) or, with star=False, in random order (it may cross
    itself)."""
    ang = rng.uniform(0, 2 * np.pi, n)
    if star:
        ang = np.sort(ang)
    rad = r * rng.uniform(0.4, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)


def seeded_footprints(n_base: int, seed: int = 0):
    """Footprints inside the NWP example's cut box: n_base star-shaped rings
    and, for every other one, a partner that overlaps it (shifted by less
    than its size; every fourth a thin bar through it, which crosses
    without a vertex inside).  Returns (rings, heights)."""
    rng = np.random.default_rng(seed)
    rings, heights = [], []
    size = 6e-5                  # ~6 m in degrees
    for i in range(n_base):
        cx = rng.uniform(CUT_LON[0] + 5 * size, CUT_LON[1] - 5 * size)
        cy = rng.uniform(CUT_LAT[0] + 5 * size, CUT_LAT[1] - 5 * size)
        rings.append(random_ring(rng, cx, cy, size, int(rng.integers(4, 9))))
        heights.append(float(rng.uniform(8, 60)))
        if i % 2 == 0:
            if i % 4 == 0:
                w = size * 0.2
                bar = np.array([[cx - 1.8 * size, cy - w], [cx + 1.8 * size, cy - w],
                                [cx + 1.8 * size, cy + w], [cx - 1.8 * size, cy + w]])
                rings.append(bar)
            else:
                dx, dy = rng.uniform(-0.8, 0.8, 2) * size
                rings.append(random_ring(rng, cx + dx, cy + dy, size,
                                         int(rng.integers(4, 9))))
            heights.append(float(rng.uniform(8, 60)))
    return rings, heights


def _prepared_case(dst: Path, **deck_changes) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(PREPARED, dst)
    if deck_changes:
        deck = load_deck(dst / "conf.luw")
        for k, v in deck_changes.items():
            deck.set_raw(k, v)
        deck.save()
    return dst / "conf.luw"


# ---- shp_reader --------------------------------------------------------------

def test_shp_reader_round_trips_across_packages(tmp_path):
    from latticeurbanwind_tpu.pre import shp_reader as jr
    from latticeurbanwind_tpu_torch.pre import shp_reader as tr

    rings, heights = seeded_footprints(20, seed=4)
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (50, 2)) + [121.3, 31.1]
    vals = rng.uniform(0, 100, 50)
    for side, mod in (("jax", jr), ("port", tr)):
        d = tmp_path / side
        d.mkdir()
        mod.write_polygon_shp(d / "b.shp", rings, heights=heights)
        mod.write_point_shp(d / "p.shp", pts, values=vals)
    _files_equal(tmp_path / "jax", tmp_path / "port",
                 [f"{s}.{e}" for s in "bp" for e in ("shp", "shx", "dbf")])
    for name in ("b.shp", "p.shp"):
        # each package reads the other's files as it reads its own
        a = tr.read_shp(tmp_path / "jax" / name)
        b = jr.read_shp(tmp_path / "port" / name)
        assert a.shape_type == b.shape_type and a.bbox == b.bbox
        assert [r.parts for r in a.records] == [r.parts for r in b.records]
        assert a.fields == b.fields and a.attributes == b.attributes
    f = tr.read_shp(tmp_path / "port" / "b.shp")
    assert len(f.records) == len(rings)
    assert [round(r["height"], 4) for r in f.attributes] == \
        [round(h, 4) for h in heights]
    assert not any(tr.polygon_defects(r) for r in f.records)


# ---- the even-odd test ---------------------------------------------------------

def _edge_distance(ring, pts):
    a = ring[None, :, :]
    b = np.roll(ring, -1, axis=0)[None, :, :]
    p = pts[:, None, :]
    d = b - a
    t = np.clip(((p - a) * d).sum(-1) / np.maximum((d * d).sum(-1), 1e-300), 0, 1)
    return np.linalg.norm(p - (a + t[..., None] * d), axis=-1).min(axis=1)


@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("closed", [True, False])
def test_points_in_ring_matches_matplotlib(star, closed):
    from matplotlib.path import Path as MplPath

    from latticeurbanwind_tpu_torch.pre.shpcutter import points_in_ring

    rng = np.random.default_rng(11 + 2 * star + closed)
    checked = 0
    for _ in range(60):
        ring = random_ring(rng, 0.0, 0.0, 1.0, int(rng.integers(3, 12)), star=star)
        if closed:
            ring = np.vstack([ring, ring[:1]])
        pts = rng.uniform(-1.2, 1.2, (400, 2))
        # the ring's own vertices and points on its axis-aligned lines
        pts = np.vstack([pts, ring + rng.uniform(-1e-3, 1e-3, ring.shape)])
        keep = _edge_distance(ring, pts) > 1e-9
        got = points_in_ring(ring, pts[keep])
        want = MplPath(ring).contains_points(pts[keep])
        np.testing.assert_array_equal(got, want)
        checked += int(keep.sum())
        assert 0 < got.sum() < len(got)
    assert checked > 20000


# ---- luwcut --------------------------------------------------------------------

def test_luwcut_seeded_district_matches_jax(tmp_path):
    """~300 footprints, half of them in overlapping pairs (crossing bars
    among them), over the prepared NWP deck: buildings.csv and the cropped
    shapefile byte for byte; the preview PNG through io/png.py."""
    from latticeurbanwind_tpu.pre.shp_reader import write_polygon_shp
    from latticeurbanwind_tpu.pre.shpcutter import main as jax_cut
    from latticeurbanwind_tpu_torch.io.png import png_size
    from latticeurbanwind_tpu_torch.pre.shpcutter import main as port_cut

    rings, heights = seeded_footprints(200, seed=1)
    # and two outside the cut box, which both drop
    rings += [r + [0.05, 0.0] for r in rings[:2]]
    heights += heights[:2]
    assert 290 <= len(rings) <= 310
    outs = {}
    for side, cut in (("jax", jax_cut), ("port", port_cut)):
        deck = _prepared_case(tmp_path / side)
        (deck.parent / "building_db").mkdir()
        write_polygon_shp(deck.parent / "building_db" / "b.shp", rings,
                          heights=heights)
        assert cut([str(deck)]) == 0
        outs[side] = deck.parent / "proj_temp"
    _files_equal(outs["jax"], outs["port"],
                 ["buildings.csv"] + [f"NwpDemo_buildings.{e}"
                                      for e in ("shp", "shx", "dbf")])
    rows = (outs["port"] / "buildings.csv").read_text().splitlines()[1:]
    ids = {r.split(",")[0] for r in rows}
    assert len(ids) == len(rings) - 2
    # the merge raised members of overlap clusters to their cluster's height
    h_by_id = {r.split(",")[0]: float(r.split(",")[3]) for r in rows}
    raised = sum(h_by_id[str(i)] > round(h, 2) + 1e-9
                 for i, h in enumerate(heights[:-2]))
    assert raised > 40
    png = outs["port"] / "NwpDemo_buildings.png"
    assert png_size(png) == (770, 770)
    data = png.read_bytes()
    assert b"tEXtTitle\x00NwpDemo: 300 footprints" in data
    # outlines drawn: some pixels are blue
    i = data.index(b"IDAT")
    n = struct.unpack(">I", data[i - 4:i])[0]
    raw = np.frombuffer(zlib.decompress(data[i + 4:i + 4 + n]), np.uint8)
    img = raw.reshape(770, 1 + 3 * 770)[:, 1:].reshape(770, 770, 3)
    blue = (img[..., 2] == 255) & (img[..., 0] == 0)
    assert 1000 < blue.sum() < 0.5 * 770 * 770


# ---- luwdem --------------------------------------------------------------------

def seeded_hill_csv(path: Path, n: int = 400, seed: int = 2, duplicates: int = 0):
    """A lon,lat,elev CSV over the NWP example's cut box (with margin): a
    Gaussian hill of 100 m plus 2 m of seeded noise."""
    rng = np.random.default_rng(seed)
    lon = rng.uniform(CUT_LON[0] - 0.004, CUT_LON[1] + 0.004, n)
    lat = rng.uniform(CUT_LAT[0] - 0.004, CUT_LAT[1] + 0.004, n)
    cx, cy = np.mean(CUT_LON), np.mean(CUT_LAT)
    elev = 100.0 * np.exp(-(((lon - cx) / 0.01) ** 2 + ((lat - cy) / 0.008) ** 2))
    elev += rng.normal(0, 2.0, n)
    if duplicates:
        lon = np.concatenate([lon, lon[:duplicates]])
        lat = np.concatenate([lat, lat[:duplicates]])
        elev = np.concatenate([elev, elev[:duplicates]])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, np.column_stack([lon, lat, elev]), delimiter=",",
               header="lon,lat,elev", comments="", fmt="%.8f")
    return path


def test_luwdem_csv_matches_jax(tmp_path):
    from latticeurbanwind_tpu.pre.dem_ingest import main as jax_dem
    from latticeurbanwind_tpu_torch.pre.dem_ingest import main as port_dem

    homes = {}
    for side, dem in (("jax", jax_dem), ("port", port_dem)):
        deck = _prepared_case(tmp_path / side,
                              manual_lon="[121.308, 121.340]",
                              manual_lat="[31.108, 31.132]")
        seeded_hill_csv(deck.parent / "database" / "hill_dem.csv", n=600)
        assert dem([str(deck)]) == 0
        homes[side] = deck.parent
    _files_equal(homes["jax"], homes["port"],
                 ["proj_temp/dem_points.csv"]
                 + [f"terrain_db/dem_points.{e}" for e in ("shp", "shx", "dbf")])
    pts = np.loadtxt(homes["port"] / "proj_temp" / "dem_points.csv",
                     delimiter=",", skiprows=1)
    assert 300 < len(pts) <= 600 and pts[:, 2].max() > 80


# ---- terrain -------------------------------------------------------------------

def _hill_points(n, seed=3, duplicates=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 3000, (n, 2))
    z = 100.0 * np.exp(-(((xy[:, 0] - 1500) / 700) ** 2
                         + ((xy[:, 1] - 1300) / 600) ** 2))
    z = z + rng.normal(0, 1.0, n)
    if duplicates:
        xy = np.vstack([xy, xy[:duplicates]])
        z = np.concatenate([z, z[:duplicates]])
    return xy, z


def _targets(n_side):
    g = np.linspace(3.3, 2996.7, n_side)
    gx, gy = np.meshgrid(g, g)
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def test_idw_and_float64_kriging_equal_jax():
    from latticeurbanwind_tpu.pre import terrain as jt
    from latticeurbanwind_tpu_torch.pre import terrain as tt

    xy, z = _hill_points(800)
    q = np.vstack([_targets(40), xy[:5]])          # five exact hits
    np.testing.assert_array_equal(
        tt.idw_interpolate(xy, z, q, power=2.0, neighbors=12),
        jt.idw_interpolate(xy, z, q, power=2.0, neighbors=12))
    got = tt.kriging_interpolate(xy, z, q, neighbors=12)
    np.testing.assert_array_equal(
        got, jt.kriging_interpolate(xy, z, q, neighbors=12, use_jax=False))
    np.testing.assert_array_equal(got[-5:], z[:5])
    assert np.isfinite(got).all()


def test_kriging_gpu_on_cpu_matches_jax_float32_solve():
    """5,000 DEM points, 3,600 targets: the port's float32 device solve on
    the CPU against the JAX package's float32 `jnp.linalg.solve`."""
    from latticeurbanwind_tpu.pre import terrain as jt
    from latticeurbanwind_tpu_torch.pre import terrain as tt

    xy, z = _hill_points(5000)
    q = _targets(60)
    got = tt.kriging_interpolate(xy, z, q, neighbors=12, device="cpu")
    ref = jt.kriging_interpolate(xy, z, q, neighbors=12, use_jax=True)
    f64 = tt.kriging_interpolate(xy, z, q, neighbors=12)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 1e-3
    assert np.abs(got - f64).max() < 1e-3
    assert np.abs(got - f64).max() > 0         # it did solve in float32


def test_kriging_gpu_singular_systems_fall_to_idw(monkeypatch):
    """Duplicated DEM points make a target's system singular when both
    copies are among its neighbours.  Where torch's LU meets the zero pivot
    (`info` != 0) the port gives that target, and only that one, its IDW
    value, as the JAX package does where `jnp.linalg.solve` returns NaN.
    The two LU codes round the identical rows apart differently, so they do
    not meet an exact zero on the same systems (on this seed torch flags
    566 of the 622 singular systems, and the JAX solve is NaN on 113, 8 of
    them among torch's 56 others); where no zero pivot shows, both solve
    the singular system in float32 as it comes.  Both are finite
    everywhere and agree within 1e-3 m wherever no duplicate is a
    neighbour."""
    from latticeurbanwind_tpu.pre import terrain as jt
    from latticeurbanwind_tpu_torch.pre import terrain as tt

    xy, z = _hill_points(600, duplicates=60)
    q = _targets(30)
    idx, _ = tt._knn(xy, q, 12)
    dup = ((idx < 60)[:, :, None] & (idx[:, None, :] == idx[:, :, None] + 600)
           ).any(axis=(1, 2))
    assert 10 < dup.sum() < len(q) - 10
    seen = {}
    solve_ex, idw = torch.linalg.solve_ex, tt.idw_interpolate

    def solve_spy(A, b):
        sol, info = solve_ex(A, b)
        seen["info"] = info.numpy().copy()
        return sol, info

    def idw_spy(points, values, targets, **kw):
        seen["idw_targets"] = targets.copy()
        return idw(points, values, targets, **kw)

    monkeypatch.setattr(torch.linalg, "solve_ex", solve_spy)
    monkeypatch.setattr(tt, "idw_interpolate", idw_spy)
    got = tt.kriging_interpolate(xy, z, q, neighbors=12, device="cpu")
    ref = jt.kriging_interpolate(xy, z, q, neighbors=12, use_jax=True)
    flagged = seen["info"] != 0
    assert flagged.any() and not flagged[~dup].any()
    np.testing.assert_array_equal(seen["idw_targets"], q[flagged])
    np.testing.assert_array_equal(got[flagged],
                                  idw(xy, z, q[flagged], neighbors=12))
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    assert np.abs(got[~dup] - ref[~dup]).max() < 1e-3
    # the solve flags exactly the systems with a zero pivot
    A = np.eye(3)[None].repeat(2, axis=0)
    A[1, 2] = A[1, 1]
    sol = tt.solve_systems(A, np.ones((2, 3)), "cpu")
    np.testing.assert_array_equal(sol[0], 1.0)
    assert np.isnan(sol[1]).all()


def test_kriging_gpu_on_cuda_without_a_card_raises(monkeypatch):
    from latticeurbanwind_tpu_torch.pre import terrain as tt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xy, z = _hill_points(50)
    with pytest.raises(RuntimeError, match="no CUDA device.*--device cpu"):
        tt.kriging_interpolate(xy, z, _targets(4), device="cuda")
    cfg = tt.TerrainConfig(approach="kriging_gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.interpolate_terrain_grid(xy, z, np.linspace(0, 3000, 4),
                                    np.linspace(0, 3000, 4), cfg)
    # idw and float64 kriging never ask for a device
    for approach in ("idw", "kriging"):
        g = tt.interpolate_terrain_grid(
            xy, z, np.linspace(0, 3000, 4), np.linspace(0, 3000, 4),
            tt.TerrainConfig(approach=approach), device="cuda")
        assert np.isfinite(g).all()


# ---- luwvox --------------------------------------------------------------------

@pytest.mark.parametrize("approach", ["idw", "kriging"])
def test_luwvox_outputs_equal_jax(tmp_path, approach):
    """The prepared NWP case with seeded DEM points and the example's
    footprints: interpolated_dem.csv and the case STL byte for byte."""
    from latticeurbanwind_tpu.pre.voxelization import main as jax_vox
    from latticeurbanwind_tpu_torch.pre.voxelization import main as port_vox

    xy, z = _hill_points(1500, seed=8)
    homes = {}
    for side, vox, extra in (("jax", jax_vox, []),
                             ("port", port_vox, ["--device", "cpu"])):
        deck = _prepared_case(tmp_path / side, terr_voxel_approach=approach,
                              terr_voxel_grid_resolution="40")
        home = deck.parent
        shutil.copy(REPO / "examples" / "example_NWP-LBM" / "building_db"
                    / "buildings.shp", home / "x.shp")   # not read: no GIS stack
        np.savetxt(home / "proj_temp" / "dem_points.csv",
                   np.column_stack([xy, z]), delimiter=",",
                   header="x,y,elevation", comments="", fmt="%.4f")
        (home / "proj_temp" / "buildings.csv").write_text(
            "id,x,y,height\n0,100,100,20\n0,160,100,20\n0,160,150,20\n"
            "1,1500,1300,30\n1,1540,1300,30\n1,1540,1350,30\n1,1500,1350,30\n")
        assert vox([str(deck)] + extra) == 0
        homes[side] = home
    _files_equal(homes["jax"], homes["port"],
                 ["proj_temp/interpolated_dem.csv", "proj_temp/NwpDemo_DG.stl"])
    dem = np.loadtxt(homes["port"] / "proj_temp" / "interpolated_dem.csv",
                     delimiter=",", skiprows=1)
    assert dem[:, 2].max() > 60


def test_luwvox_usage_and_device_option():
    from latticeurbanwind_tpu_torch.cli import pop_device
    from latticeurbanwind_tpu_torch.pre.voxelization import main

    assert pop_device(["a.luw"]) == (["a.luw"], "cuda")
    assert pop_device(["--device", "cpu", "a.luw"]) == (["a.luw"], "cpu")
    assert pop_device(["a.luw", "--device=cuda:1"]) == (["a.luw"], "cuda:1")
    assert main([]) == 2 and main(["a", "b"]) == 2


# ---- luwval --------------------------------------------------------------------

def test_luwval_pass_and_fail_match_jax(tmp_path):
    from latticeurbanwind_tpu.cli.validate import main as jax_val
    from latticeurbanwind_tpu_torch.cli.validate import main as port_val
    from latticeurbanwind_tpu_torch.deck import load_deck

    for case, shift in (("pass", 0.0), ("fail", 50.0)):
        decks = {}
        for side, val in (("jax", jax_val), ("port", port_val)):
            deck = _prepared_case(tmp_path / case / side, validation="error")
            if shift:
                csv = deck.parent / "proj_temp" / "SurfData_20260101120000.csv"
                lines = csv.read_text().splitlines()
                body = [f"{float(r.split(',')[0]) + shift:.6f},"
                        + r.split(",", 1)[1] for r in lines[1:]]
                csv.write_text("\n".join([lines[0]] + body) + "\n")
            assert val([str(deck)]) == 0
            decks[side] = deck
        assert decks["jax"].read_text() == decks["port"].read_text()
        assert load_deck(decks["port"]).get_text("validation") == \
            ("pass" if not shift else "error")
    assert port_val([]) == 2


def test_luwval_gpu_memory_default(tmp_path, monkeypatch):
    """A deck without mesh_control gets gpu_memory: 20000 MiB without a
    card, as the JAX package writes off a TPU; 85% of the card's memory
    with one."""
    from latticeurbanwind_tpu.cli.validate import main as jax_val
    from latticeurbanwind_tpu_torch.cli import validate as tv
    from latticeurbanwind_tpu_torch.deck import load_deck

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    decks = {}
    for side, val in (("jax", jax_val), ("port", tv.main)):
        deck = _prepared_case(tmp_path / side)
        text = deck.read_text().replace('mesh_control = "cell_size"\n', "")
        deck.write_text(text)
        assert "mesh_control" not in deck.read_text()
        assert val([str(deck)]) == 0
        decks[side] = deck
    assert decks["jax"].read_text() == decks["port"].read_text()
    d = load_deck(decks["port"])
    assert d.get_int("gpu_memory") == 20000
    assert d.get_text("mesh_control") == "gpu_memory"

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    assert tv.default_memory_mib() == int(80 * 1024 * 0.85)


# ---- cleanluw and the inspectors --------------------------------------------------

def test_cleanluw_and_inspectors(tmp_path, capsys):
    from latticeurbanwind_tpu_torch.cli import clean, inspect_tools

    case = tmp_path / "c"
    shutil.copytree(REPO / "examples" / "example_NWP-LBM", case)
    deck = case / "conf.luw"
    assert inspect_tools.cdfinspect_main([str(deck)]) == 0
    out = capsys.readouterr().out
    assert "XLONG" in out and "U" in out
    rc = inspect_tools.shpinspect_main([str(deck)])
    try:
        import geopandas  # noqa: F401
    except ImportError:
        assert rc == 1          # not required: makeluw goes on without it
    assert inspect_tools.resolve_shp_path(case, None).name == "buildings.shp"
    (case / "proj_temp" / "sub").mkdir(parents=True)
    (case / "proj_temp" / "a.txt").write_text("x")
    (case / "proj_temp" / "sub" / "b.txt").write_text("y")
    assert clean.main([str(deck)]) == 0
    assert (case / "proj_temp" / "sub").is_dir()
    assert not any(p.is_file() for p in (case / "proj_temp").rglob("*"))
    assert clean.main([]) == 1
