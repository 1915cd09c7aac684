"""PyTorch port, the studio (`gui/server.py`, `gui/stream.py`) against the
JAX package's (tests/test_gui_studio.py's cases).

Both studios are up on port 0 over the same seeded case, each in a
directory of its own, and answer the same requests.  JSON answers (tree,
schema, deck get/post, results, series, batch, volinfo, vtkinfo, pick) are
equal once each studio's root is put in place of the other's; `/api/env`
differs by design (torch, the cards, the kernels' build instead of JAX).
Bricks and pyramids are equal byte for byte.  The port draws its PNG panels
through `io/figure.py` and the JAX studio through matplotlib, so PNGs are
held by validity, size and the JAX figure's titles (each matplotlib title
the JAX studio sets stands in the port PNG's `tEXt` chunk, in the latin-1
that chunk holds, the em dash as "?"; the JAX `savefig` is replaced by a
stub, which keeps these tests fast).  A port job runs `runluw` on a tiny
profile deck with `--device cpu` in a child process; its VTKs equal a
direct `run_deck` of the same deck byte for byte.
"""

import json
import shutil
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from latticeurbanwind_tpu.io.vtk import write_structured_points

SIDES = ("jax", "port")
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "example_ProfileResearch_noDEM"
VTK0 = "RESULTS/vtk/demo_avg-000000010.vtk"


def png_chunks(raw: bytes) -> dict:
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind, data = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(kind + data) & 0xFFFFFFFF
        chunks.setdefault(kind, []).append(data)
        pos += 12 + n
    return chunks


def hold_png(raw: bytes, jax_titles) -> tuple:
    """A valid RGB8 PNG whose pixels decompress to its size, holding every
    JAX title in its text chunk; returns (width, height)."""
    chunks = png_chunks(raw)
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][0][:10])
    assert (depth, color) == (8, 2) and w > 0 and h > 0
    assert len(zlib.decompress(b"".join(chunks[b"IDAT"]))) == h * (1 + 3 * w)
    text = [t[6:].decode("latin-1") for t in chunks.get(b"tEXt", [])
            if t.startswith(b"Title\x00")]
    held = set("; ".join(text).split("; "))
    want = {t.encode("latin-1", "replace").decode("latin-1") for t in jax_titles}
    assert want and want <= held, (want, held)
    return w, h


@pytest.fixture
def mpl_titles(monkeypatch):
    """The titles (axes and figure) the JAX studio sets for each figure it
    saves, in order; its savefig writes no image."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.axes
    import matplotlib.figure

    titles, saved = [], []
    set_title = matplotlib.axes.Axes.set_title
    suptitle = matplotlib.figure.Figure.suptitle

    def record_title(self, label, *a, **k):
        titles.append(label)
        return set_title(self, label, *a, **k)

    def record_suptitle(self, t, *a, **k):
        titles.append(t)
        return suptitle(self, t, *a, **k)

    def savefig(self, fname, *a, **k):
        if hasattr(fname, "write"):
            fname.write(b"")
        else:
            Path(fname).write_bytes(b"")
        saved.append(list(titles))
        titles.clear()

    monkeypatch.setattr(matplotlib.axes.Axes, "set_title", record_title)
    monkeypatch.setattr(matplotlib.figure.Figure, "suptitle", record_suptitle)
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return saved


def seed_case(case: Path) -> Path:
    """tests/test_gui_studio.py's case."""
    (case / "proj_temp").mkdir(parents=True)
    (case / "RESULTS" / "vtk").mkdir(parents=True)
    (case / "conf.luw").write_text(
        "// LUW deck\n\n// Project\ncasename = demo\n\n"
        "// CFD Controls\ngpu_memory = 1000\n")
    u = np.full((3, 6, 10, 12), 2.0, np.float32)
    write_structured_points(case / VTK0, {"u_avg": u}, spacing=5.0)
    return case


class Side:
    def __init__(self, name, case, httpd):
        self.name, self.case, self.httpd = name, case, httpd
        self.base = f"http://127.0.0.1:{httpd.server_address[1]}"
        self.thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return r.headers.get_content_type(), r.read(), r.headers

    def json(self, path, post=None):
        url = self.base + path
        req = (urllib.request.Request(url, data=json.dumps(post).encode(),
                                      method="POST") if post is not None else url)
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:   # error answers carry JSON
            return json.loads(e.read())

    def png(self, path):
        ctype, body, _ = self.get(path)
        assert ctype == "image/png"
        return body

    def wait(self, job_id, seconds=120):
        t0 = time.time()
        while time.time() - t0 < seconds:
            st = self.json(f"/api/job?id={job_id}")
            if st["done"]:
                return st
            time.sleep(0.1)
        raise AssertionError(f"job {job_id} not done in {seconds} s")


@pytest.fixture
def studios(tmp_path):
    from latticeurbanwind_tpu.gui.server import serve as jax_serve
    from latticeurbanwind_tpu_torch.gui.server import serve as port_serve

    sides = {}
    for name, serve in zip(SIDES, (jax_serve, port_serve)):
        case = seed_case(tmp_path / name / "case")
        sides[name] = Side(name, case, serve(case, port=0))
    yield sides
    for s in sides.values():
        s.httpd.shutdown()
        s.httpd.server_close()
        s.thread.join(10)
        assert not s.thread.is_alive()


def both(studios, fn):
    """fn(side) on both studios, each answer with its root put as <root>."""
    out = []
    for s in studios.values():
        text = json.dumps(fn(s)).replace(str(s.case.resolve()), "<root>")
        out.append(json.loads(text))
    return out


def same_json(studios, fn):
    jax, port = both(studios, fn)
    assert port == jax
    return port


def write_both(studios, rel, fields, **kw):
    for s in studios.values():
        write_structured_points(s.case / rel, fields, **kw)


def test_studio_endpoints(studios):
    from latticeurbanwind_tpu_torch.gui import server

    port = studios["port"]
    assert server.APP_HTML.parent == Path(server.__file__).parent
    ctype, html, _ = port.get("/")
    assert ctype == "text/html" and b"LUW" in html
    assert html == server.APP_HTML.read_bytes()

    tree = same_json(studios, lambda s: s.json("/api/tree"))
    assert {"conf.luw", "RESULTS"} <= {i["name"] for i in tree["items"]}
    schema = same_json(studios, lambda s: s.json("/api/schema?mode=luw"))
    keys = {f["key"] for s in schema["sections"] for f in s["fields"]}
    assert {"casename", "gpu_memory", "lbm_storage"} <= keys
    assert same_json(studios, lambda s: s.json("/api/deck?path=conf.luw")
                     )["values"]["casename"] == "demo"
    saved = same_json(studios, lambda s: s.json(
        "/api/deck", post={"path": "conf.luw", "values": {"gpu_memory": "512"}}))
    assert saved["values"]["gpu_memory"] == "512"
    assert "gpu_memory = 512" in (port.case / "conf.luw").read_text()
    bad = same_json(studios, lambda s: s.json("/api/deck?path=../../etc/passwd"))
    assert "error" in bad
    res = same_json(studios, lambda s: s.json("/api/results?path="))
    assert res["vtks"] == [VTK0]
    info = same_json(studios, lambda s: s.json(f"/api/vtkinfo?path={VTK0}"))
    assert info["fields"]["u_avg"] == [3, 6, 10, 12]
    assert same_json(studios, lambda s: s.json("/api/nosuch")) == {"error": "not found"}


def test_studio_slice_render(studios, mpl_titles):
    studios["jax"].png(f"/api/render?path={VTK0}&z=2")
    w, h = hold_png(studios["port"].png(f"/api/render?path={VTK0}&z=2"),
                    mpl_titles[-1])
    assert w * h > 5000


def test_studio_job_runner(studios, monkeypatch):
    # the JAX studio's child finds its package through the caller's path
    monkeypatch.setenv("PYTHONPATH", str(Path(__file__).resolve().parents[1]))
    jobs = {}
    for s in studios.values():
        job = s.json("/api/run", post={"cmd": "cleanluw", "args": ["--dry-run"],
                                       "cwd": ""})
        jobs[s.name] = job
        s.wait(job["id"])
        bad = s.json("/api/run", post={"cmd": "rm", "args": ["-rf", "/"]})
        assert "error" in bad
    # cleanluw takes a deck path: both children refuse "--dry-run" alike
    done = both(studios, lambda s: s.wait(jobs[s.name]["id"]))
    assert done[0]["lines"] == done[1]["lines"] and done[0]["lines"]
    assert done[0]["rc"] == done[1]["rc"] == 1
    assert jobs["port"]["argv"][1:] == ["-m", "latticeurbanwind_tpu_torch.cli.dispatch",
                                        "cleanluw", "--dry-run"]
    from latticeurbanwind_tpu.gui.server import ALLOWED_COMMANDS as JAX_ALLOWED
    from latticeurbanwind_tpu_torch.gui.server import ALLOWED_COMMANDS

    assert sorted(ALLOWED_COMMANDS) == sorted(JAX_ALLOWED)


def test_studio_failed_job_shows_its_exit_code(studios):
    """A job whose child fails shows that exit code; nothing reruns it."""
    port = studios["port"]
    job = port.json("/api/run", post={"cmd": "runluw", "args": ["missing.luwpf",
                                                                "--device", "cpu"]})
    st = port.wait(job["id"])
    assert st["rc"] not in (0, None)
    assert len(port.httpd.studio.jobs) == 1


def test_studio_mip_and_q_render(studios, mpl_titles):
    for params in ("mode=mip&axis=y&field=u_avg", "field=Q&mode=mip"):
        path = f"/api/render?path={VTK0}&" + params
        studios["jax"].png(path)
        hold_png(studios["port"].png(path), mpl_titles[-1])


def test_studio_3d_render_and_series(studios, mpl_titles):
    write_both(studios, "RESULTS/vtk/demo_avg-000000020.vtk",
               {"u_avg": np.full((3, 6, 10, 12), 3.0, np.float32)}, spacing=5.0)
    s = same_json(studios, lambda s: s.json(f"/api/series?path={VTK0}"))
    assert s["steps"] == [10, 20] and len(s["files"]) == 2
    path = f"/api/render?path={VTK0}&mode=3d&az=200&el=40&sl=1&q=0"
    studios["jax"].png(path)
    w, h = hold_png(studios["port"].png(path), mpl_titles[-1])
    assert (w, h) == (820, 600)


def test_studio_boundary_panel(studios, mpl_titles):
    rows = ["X,Y,Z,u,v,w,patch"]
    rng = np.random.default_rng(0)
    for p in range(6):
        for _ in range(20):
            rows.append(f"{rng.uniform(0,100):.2f},{rng.uniform(0,100):.2f},"
                        f"{rng.uniform(0,50):.2f},3.0,1.0,0.0,{p}")
    for s in studios.values():
        (s.case / "proj_temp" / "SurfData_20250101.csv").write_text(
            "\n".join(rows) + "\n")
    r = same_json(studios, lambda s: s.json("/api/results?path="))
    assert any("SurfData" in c for c in r["csvs"])
    path = "/api/boundary?path=proj_temp/SurfData_20250101.csv"
    studios["jax"].png(path)
    w, h = hold_png(studios["port"].png(path), mpl_titles[-1])
    assert len(mpl_titles[-1]) == 4 and w * h > 5000


def test_studio_spectra_and_morphology_panels(studios, mpl_titles):
    rng = np.random.default_rng(7)
    u = rng.normal(3.0, 0.5, (3, 8, 24, 32)).astype(np.float32)
    fluid = np.ones((8, 24, 32), np.float32)
    fluid[:4, 5:9, 6:12] = 0.0           # one building block
    fluid[:6, 14:18, 20:26] = 0.0        # a taller one
    u[:, fluid == 0.0] = 0.0
    write_both(studios, "RESULTS/vtk/city_avg-000000030.vtk",
               {"u_avg": u, "fluid": fluid}, spacing=4.0)
    for panel in ("spectra", "buildingscale"):
        path = f"/api/{panel}?path=RESULTS/vtk/city_avg-000000030.vtk"
        studios["jax"].png(path)
        hold_png(studios["port"].png(path), mpl_titles[-1])
    assert len(mpl_titles[-1]) == 4      # three axes and the figure's


def test_vtk_cache_and_decimation(tmp_path):
    import os

    from latticeurbanwind_tpu.gui.server import _decimate as jax_decimate
    from latticeurbanwind_tpu_torch.gui.server import _VtkCache, _decimate

    p = tmp_path / "a-000000010.vtk"
    write_structured_points(p, {"rho": np.ones((4, 5, 6), np.float32)})
    cache = _VtkCache(capacity=2)
    _, f1 = cache.get(p)
    _, f2 = cache.get(p)
    assert f1 is f2                       # served from cache
    write_structured_points(p, {"rho": np.full((4, 5, 6), 2.0, np.float32)})
    os.utime(p, ns=(1, 10**18))           # force a different mtime_ns
    _, f3 = cache.get(p)
    assert f3 is not f2 and float(f3["rho"][0, 0, 0]) == 2.0

    big = np.arange(3 * 40 * 600 * 600, dtype=np.float32).reshape(3, 40, 600, 600)
    for in_plane in (False, True):
        got, want = _decimate(big, in_plane), jax_decimate(big, in_plane)
        assert got[1] == want[1] > 1 and np.array_equal(got[0], want[0])
        assert int(np.prod(got[0].shape[-3:])) <= 2_000_000
    assert _decimate(big, True)[0].shape[-3] == 40
    assert _decimate(np.zeros((10, 20, 30), np.float32))[1] == 1


def test_studio_batch_panel(studios, mpl_titles):
    b = same_json(studios, lambda s: s.json("/api/batch?path=conf.luw"))
    assert b["mode"] == "luw" and "gpu_memory" in b["summary"]
    for s in studios.values():
        (s.case / "conf.luwdg").write_text(
            "// LUW deck\n\n// Project\ncasename = demo\n\n"
            "// Batch\ninflow = [2.0, 5.0]\nangle = [0, 90]\n")
        (s.case / "wind_bc").mkdir()
        (s.case / "wind_bc" / "profile.dat").write_text(
            "0.0 0.0\n50.0 4.0\n100.0 6.0\n200.0 8.0\n")
        (s.case / "conf.luwpf").write_text(
            "// LUW deck\n\n// Project\ncasename = demo\n\n"
            "// Batch\nangle = [0, 45]\n")
    b = same_json(studios, lambda s: s.json("/api/batch?path=conf.luwdg"))
    assert b["matrix"] == [["DG_2_0_", "DG_2_90_"], ["DG_5_0_", "DG_5_90_"]]
    b = same_json(studios, lambda s: s.json("/api/batch?path=conf.luwpf"))
    assert [c["case"] for c in b["cases"]] == ["ANG_0_", "ANG_45_"]
    assert b["profile"][-1] == [200.0, 8.0]
    studios["jax"].png("/api/profileplot?path=conf.luwpf")
    hold_png(studios["port"].png("/api/profileplot?path=conf.luwpf"),
             mpl_titles[-1])


def test_studio_volume_field_render(studios, mpl_titles):
    rng = np.random.default_rng(7)
    u = rng.normal(2.0, 0.5, (3, 6, 10, 12)).astype(np.float32)
    rho = (1.0 + rng.normal(0, 0.01, (6, 10, 12))).astype(np.float32)
    T = (293.0 + rng.normal(0, 2.0, (6, 10, 12))).astype(np.float32)
    write_both(studios, "RESULTS/vtk/vol_avg-000000010.vtk",
               {"u_avg": u, "rho_avg": rho, "T_avg": T}, spacing=5.0)
    for extra in ("color=u", "color=rho", "color=T&gain=2.5",
                  "color=u&splane=z:3"):
        path = ("/api/render?path=RESULTS/vtk/vol_avg-000000010.vtk"
                "&mode=volume&az=210&el=30&" + extra)
        studios["jax"].png(path)
        hold_png(studios["port"].png(path), mpl_titles[-1])
    err = same_json(studios, lambda s: s.json(
        f"/api/render?path={VTK0}&mode=volume&color=T"))
    assert "error" in err


def test_studio_aij_validation_panel(studios, mpl_titles):
    """The luwaij-backed panel on a seeded Case E workbook (the real one is
    not in the repository; tests/test_torch_aij.py writes its layout) and
    an executed single-angle .luwpf case."""
    from test_torch_aij import casee_workbook

    u = np.full((3, 20, 60, 60), 2.0, np.float32)
    fl = np.ones((20, 60, 60), np.float32)
    for s in studios.values():
        casee_workbook(s.case / "CaseE(test).xls", seed=3)
        (s.case / "wind_bc").mkdir(exist_ok=True)
        (s.case / "wind_bc" / "profile.dat").write_text(
            "1.25 2.847\n25 4.36\n250 7.8\n")
        (s.case / "conf.luwpf").write_text(
            "// LUW deck\n\n// Project\ncasename = demo\ndatetime = 1\n\n"
            "// Domain\nbase_height = 20.0\n\n// Batch\nangle = [0]\n")
        write_structured_points(s.case / "RESULTS" / "vtk" / "1_avg-000000010.vtk",
                                {"u_avg": u, "fluid": fl}, spacing=10.0)
    b = same_json(studios, lambda s: s.json("/api/batch?path=conf.luwpf"))
    assert b["has_xls"] is True
    studios["jax"].png("/api/aij?path=conf.luwpf&variant=after")
    png = studios["port"].png("/api/aij?path=conf.luwpf&variant=after")
    # luwaij's own figure (the error map is saved first), its title's line
    # break and double spaces as single spaces
    assert png == (studios["port"].case / "RESULTS" / "aij_casee_after.png").read_bytes()
    hold_png(png, [" ".join(t.split()) for t in mpl_titles[-1]])
    names = [sorted(p.name for p in (s.case / "RESULTS").glob("aij_casee_*"))
             for s in studios.values()]
    assert names[0] == names[1]
    err = same_json(studios, lambda s: s.json(
        "/api/aij?path=RESULTS/vtk/1_avg-000000010.vtk"))
    assert err == {"error": "ValueError: no .xls dataset next to the deck"}


def test_mip_pyramid_levels_and_bricks():
    from latticeurbanwind_tpu.gui import stream as J
    from latticeurbanwind_tpu_torch.gui import stream as T

    rng = np.random.default_rng(3)
    vol = rng.uniform(0.0, 9.0, (40, 130, 70)).astype(np.float32)
    pyr, ref = T.MipPyramid(vol, brick_size=64), J.MipPyramid(vol, brick_size=64)
    assert [list(l.shape) for l in pyr.levels] == [
        [40, 130, 70], [20, 65, 35], [10, 33, 18]]
    assert all(np.array_equal(a, b) for a, b in zip(pyr.levels, ref.levels))
    assert pyr.info() == ref.info()
    assert pyr.vmin == float(vol.min()) and pyr.vmax == float(vol.max())
    for lvl in range(pyr.n_levels()):
        nz, ny, nx = pyr.bricks_at(lvl)
        for i in range(nz):
            for j in range(ny):
                for k in range(nx):
                    t = pyr.brick(lvl, i, j, k)
                    assert t.dtype == np.float16
                    assert t.tobytes() == ref.brick(lvl, i, j, k).tobytes()
    vec = np.stack([vol, -vol, 0 * vol])
    assert np.array_equal(T.select_scalar({"u_avg": vec}, "u"),
                          J.select_scalar({"u_avg": vec}, "u"))
    assert np.array_equal(T.select_scalar({"rho_avg": vol}, "rho"), vol)
    with pytest.raises(ValueError):
        T.select_scalar({"rho_avg": vol}, "nope")
    with pytest.raises(ValueError):
        pyr.brick(3, 0, 0, 0)


def test_studio_brick_streaming_endpoints(studios):
    rng = np.random.default_rng(11)
    u = rng.normal(2.0, 1.0, (3, 70, 80, 90)).astype(np.float32)
    path = "RESULTS/vtk/big_avg-000000050.vtk"
    write_both(studios, path, {"u_avg": u}, spacing=2.0)
    info = same_json(studios, lambda s: s.json(f"/api/volinfo?path={path}&field=u"))
    assert info["brick_size"] == 64 and info["dtype"] == "float16"
    assert [l["shape"] for l in info["levels"]] == [[70, 80, 90], [35, 40, 45]]
    for lvl, level in enumerate(info["levels"]):
        nz, ny, nx = level["bricks"]
        for i in range(nz):
            for j in range(ny):
                for k in range(nx):
                    q = f"/api/brick?path={path}&field=u&level={lvl}&i={i}&j={j}&k={k}"
                    (_, a, ha), (_, b, hb) = (s.get(q) for s in studios.values())
                    assert a == b and ha["X-Brick-Shape"] == hb["X-Brick-Shape"]
    for q in ("level=9&i=0&j=0&k=0", "level=0&i=9&j=0&k=0"):
        assert "error" in same_json(studios, lambda s: s.json(
            f"/api/brick?path={path}&field=u&{q}"))
    _, html, _ = studios["port"].get("/")
    assert b"volume (stream LOD)" in html and b"/api/brick" in html


def test_studio_brick_temporal_interpolation(studios):
    rng = np.random.default_rng(7)
    u0 = rng.normal(2.0, 1.0, (3, 20, 24, 28)).astype(np.float32)
    u1 = rng.normal(3.0, 1.0, (3, 20, 24, 28)).astype(np.float32)
    p0, p1 = ("RESULTS/vtk/fr_avg-000000010.vtk", "RESULTS/vtk/fr_avg-000000020.vtk")
    write_both(studios, p0, {"u_avg": u0})
    write_both(studios, p1, {"u_avg": u1})
    write_both(studios, "RESULTS/vtk/fr2_avg-000000030.vtk", {"u_avg": u1[:, :10]})
    b0 = None
    for extra in ("", f"&path2={p1}&alpha=0.25&interp=lerp",
                  f"&path2={p1}&alpha=-3&interp=lerp", f"&path2={p1}&alpha=-3",
                  f"&path2={p1}&alpha=0.25"):
        q = f"/api/brick?path={p0}&field=u&level=0&i=0&j=0&k=0" + extra
        (_, a, ha), (_, b, _) = (s.get(q) for s in studios.values())
        assert a == b, extra
        tile = np.frombuffer(a, np.float16)
        assert np.isfinite(tile.astype(np.float32)).all()
        if b0 is None:
            b0 = a
        elif "alpha=-3" in extra:
            assert a == b0                 # alpha clamps to [0, 1]
    bad = same_json(studios, lambda s: s.json(
        f"/api/brick?path={p0}&field=u&level=0&i=0&j=0&k=0"
        f"&path2=RESULTS/vtk/fr2_avg-000000030.vtk&alpha=0.5"))
    assert "error" in bad
    _, html, _ = studios["port"].get("/")
    assert b"path2" in html and b"sub-frame" in html


def test_studio_pick_endpoint(studios):
    u = np.zeros((3, 6, 10, 12), np.float32)
    u[0] = 1.0
    u[0, 4, 7, 3] = 9.0                      # a hot cell in column (y=7,x=3)
    rho = np.full((6, 10, 12), 1.25, np.float32)
    path = "RESULTS/vtk/pk_avg-000000010.vtk"
    write_both(studios, path, {"u_avg": u, "rho_avg": rho},
               spacing=5.0, origin=(100.0, 200.0, 30.0))
    p = same_json(studios, lambda s: s.json(f"/api/pick?path={path}&z=4&y=7&x=3"))
    assert p["cell"] == [4, 7, 3] and p["values"]["u_avg"] == [9.0, 0.0, 0.0]
    p = same_json(studios, lambda s: s.json(
        f"/api/pick?path={path}&axis=z&a=7&b=3&field=u"))
    assert p["argmax"] == 4 and p["cell"] == [4, 7, 3]
    p = same_json(studios, lambda s: s.json(
        f"/api/pick?path={path}&axis=y&a=99&b=0&field=u"))
    assert p["cell"][0] == 5
    _, html, _ = studios["port"].get("/")
    assert b"2x2 multi-view" in html and b'api("pick"' in html


def test_warp_interpolation_beats_crossfade_on_advecting_vortex(studios):
    shape = (24, 48, 48)
    zz, yy, xx = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape],
                             indexing="ij")

    def blob(cy, cx):
        return 5.0 * np.exp(-((zz - 12.0) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2)
                            / 18.0)

    f0, fmid, f1 = blob(24, 18), blob(24, 21), blob(24, 24)
    p0, p1 = ("RESULTS/vtk/adv_avg-000000010.vtk", "RESULTS/vtk/adv_avg-000000020.vtk")
    write_both(studios, p0, {"s": f0.astype(np.float32)})
    write_both(studios, p1, {"s": f1.astype(np.float32)})
    out = {}
    for extra in (f"&path2={p1}&alpha=0.5", f"&path2={p1}&alpha=0.5&interp=lerp"):
        q = f"/api/brick?path={p0}&field=s&level=0&i=0&j=0&k=0" + extra
        (_, a, ha), (_, b, _) = (s.get(q) for s in studios.values())
        assert a == b
        sh = tuple(int(v) for v in ha["X-Brick-Shape"].split(","))
        out[extra] = np.frombuffer(a, np.float16).reshape(sh).astype(np.float32)
    warp, fade = out.values()
    truth = fmid[:warp.shape[0], :warp.shape[1], :warp.shape[2]]
    err_warp, err_fade = np.abs(warp - truth).max(), np.abs(fade - truth).max()
    assert err_fade > 1.0, err_fade
    assert err_warp < err_fade / 4, (err_warp, err_fade)


def test_studio_env_reports_torch_cards_and_kernels(studios):
    import torch

    from latticeurbanwind_tpu_torch.utils import cuda_build

    env = studios["port"].json("/api/env")
    assert env["torch"] == torch.__version__ and env["cuda"] == torch.version.cuda
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert env["cards"] == cards and len(env["devices"]) == cards
    assert env["kernels"]["built"] == cuda_build.library_path().exists()
    assert env["kernels"]["library"] == cuda_build.library_path().name
    assert not any("jax" in k or "pallas" in k for k in env)


def _tiny_profile_deck(dst: Path) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLE, dst)
    deck = load_deck(dst / "conf.luwpf")
    deck.set_text("turb_inflow_enable", "false")
    deck.set_text("lbm_storage", "f32")
    deck.set_float("cell_size", 16.0)
    deck.set_text("angle", "[0]")
    deck.set_int("run_nstep", 20)
    deck.set_int("unsteady_output", 10)
    deck.set_int("purge_avg", 10)
    deck.set_int("purge_avg_stride", 2)
    deck.save()
    return dst / "conf.luwpf"


def test_studio_runluw_job_equals_a_direct_run(studios, tmp_path, monkeypatch):
    """`runluw` on a tiny profile deck as a studio job (`--device cpu`, in a
    child process of the port's dispatcher) writes the VTKs a direct
    `run_deck` of the same deck writes, byte for byte."""
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    port = studios["port"]
    deck = _tiny_profile_deck(port.case / "pf")
    job = port.json("/api/run", post={"cmd": "runluw", "cwd": "pf",
                                      "args": ["conf.luwpf", "--device", "cpu"]})
    assert job["argv"][3:] == ["runluw", "conf.luwpf", "--device", "cpu"]
    st = port.wait(job["id"], seconds=300)
    assert st["rc"] == 0, st["lines"]
    direct = run_deck(_tiny_profile_deck(tmp_path / "direct"), device="cpu",
                      quiet=True)
    want = {f.name: f for r in direct for f in r.files if f.suffix == ".vtk"}
    got = {f.name: f for f in (deck.parent / "RESULTS" / "vtk").glob("*.vtk")}
    assert sorted(got) == sorted(want) and len(got) >= 3
    for name in want:
        assert got[name].read_bytes() == want[name].read_bytes(), name


def test_studio_stops_its_jobs_when_closed(tmp_path):
    """server_close ends a job still running: no child outlives the
    studio."""
    from latticeurbanwind_tpu_torch.gui.server import Job, serve

    case = seed_case(tmp_path / "case")
    httpd = serve(case, port=0)
    studio = httpd.studio
    job = Job([sys.executable, "-c", "import time; print('up', flush=True); "
               "time.sleep(600)"], case)
    studio.jobs[job.id] = job
    t0 = time.time()
    while not job.lines and time.time() - t0 < 30:
        time.sleep(0.05)
    assert job.lines == ["up"]
    httpd.server_close()
    assert job.proc.poll() is not None and job.rc is not None
    assert time.time() - t0 < 30
