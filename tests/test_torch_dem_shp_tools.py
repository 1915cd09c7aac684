"""PyTorch port, `visdem` and `shptester` (`cli/dem_shp_tools.py`) against
the JAX package (`tests/test_dem_shp_tools.py`'s cases).

shptester prints the JAX package's report and returns its code on seeded
shapefiles (the pure-python path: geopandas stays optional); visdem reads
the same DEM CSV and writes a PNG through `io/figure.py`, whose hillshade
is matplotlib's `LightSource.hillshade`.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from latticeurbanwind_tpu.cli import dem_shp_tools as J
from latticeurbanwind_tpu_torch.cli import dem_shp_tools as T
from latticeurbanwind_tpu_torch.io.png import png_size

SQUARE = [(0.0, 0.0), (0.0, 10.0), (10.0, 10.0), (10.0, 0.0), (0.0, 0.0)]
OPEN_RING = [(0.0, 0.0), (0.0, 5.0), (5.0, 5.0), (5.0, 0.0)]
DEGENERATE = [(1.0, 1.0), (2.0, 2.0), (3.0, 3.0), (1.0, 1.0)]
TINY = [(0.0, 0.0), (1.0, 1.0)]


def _write_polygon_shp(path, polygons):
    """`tests/test_dem_shp_tools.py::_write_polygon_shp`: one ring per
    record."""
    records = b""
    for i, ring in enumerate(polygons):
        xs = [p[0] for p in ring] or [0.0]
        ys = [p[1] for p in ring] or [0.0]
        content = struct.pack("<i4d", 5, min(xs), min(ys), max(xs), max(ys))
        content += struct.pack("<ii", 1, len(ring)) + struct.pack("<i", 0)
        for x, y in ring:
            content += struct.pack("<2d", x, y)
        records += struct.pack(">ii", i + 1, len(content) // 2) + content
    xs = [p[0] for ring in polygons for p in ring] or [0.0]
    ys = [p[1] for ring in polygons for p in ring] or [0.0]
    header = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0)
    header += struct.pack(">i", (100 + len(records)) // 2)
    header += struct.pack("<ii", 1000, 5)
    header += struct.pack("<4d", min(xs), min(ys), max(xs), max(ys))
    header += struct.pack("<4d", 0, 0, 0, 0)
    path.write_bytes(header + records)


@pytest.mark.parametrize("polys", [[SQUARE, DEGENERATE], [SQUARE],
                                   [SQUARE, OPEN_RING, DEGENERATE, TINY] * 7])
def test_shptester_cli(tmp_path, capsys, polys):
    out = {}
    for side, fn in (("jax", J.shptester_main), ("port", T.shptester_main)):
        d = tmp_path / side
        (d / "building_db").mkdir(parents=True)
        _write_polygon_shp(d / "building_db" / "b.shp", polys)
        rcs = (fn([str(d / "building_db" / "b.shp")]), fn([str(d)]), fn([]),
               fn([str(d / "building_db")]))
        out[side] = (rcs, capsys.readouterr().out.replace(str(d), "<case>"))
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == (0 if len(polys) == 1 else 1)


def test_visdem_from_csv(tmp_path, capsys, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.figure
    from matplotlib.colors import LightSource

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, f, *a, **k: Path(f).write_bytes(b""))
    xs, ys = np.meshgrid(np.arange(20.0), np.arange(15.0))
    z = 5.0 + 2.0 * np.sin(xs / 3.0) + ys * 0.1
    rows = np.column_stack([xs.ravel(), ys.ravel(), z.ravel()])
    printed = {}
    for side, fn in (("jax", J.visdem_main), ("port", T.visdem_main)):
        csv = tmp_path / side / "proj_temp" / "interpolated_dem.csv"
        csv.parent.mkdir(parents=True)
        np.savetxt(csv, rows[::-1], delimiter=",", header="x,y,z", comments="")
        assert fn([str(csv), str(tmp_path / side / "dem.png")]) == 0
        assert fn([str(tmp_path / side)]) == 0          # the case dir: csv.png
        assert fn([str(tmp_path / side / "missing.csv")]) == 1
        assert fn([]) == 2
        printed[side] = capsys.readouterr().out.replace(str(tmp_path / side), "")
    assert printed["port"] == printed["jax"] and "z range" in printed["port"]
    assert png_size(tmp_path / "port" / "dem.png") == (3 * (400 + 12), 300 + 12)
    assert png_size(tmp_path / "port" / "proj_temp" / "interpolated_dem.png")[0] > 0
    (_, _), zj = J._load_dem_csv(tmp_path / "jax" / "proj_temp" / "interpolated_dem.csv")
    (_, _), zt = T._load_dem_csv(tmp_path / "port" / "proj_temp" / "interpolated_dem.csv")
    np.testing.assert_array_equal(zt, zj)
    ls = LightSource(azdeg=315, altdeg=45)
    for exag in (1.0, 2.0):
        np.testing.assert_allclose(T.hillshade(z, vert_exag=exag),
                                   ls.hillshade(z, vert_exag=exag), atol=1e-12)
