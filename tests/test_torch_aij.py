"""PyTorch port, `io/xls.py` and `luwaij` (`post/aij_casee.py`) against the
JAX package.

The AIJ Case E workbook is not in the repository, so the port is held to
the JAX package on synthetic inputs: the BIFF record layer
(`tests/test_aij_validation.py`'s cases), a seeded Case E-shaped workbook
written here as an OLE2 (CFB v3) file, and `validate_deck` on a seeded
two-angle profile case: the same statistics, the same CSV of measured and
computed ratios byte for byte, and the same figure names (the port draws
through `io/figure.py`).
"""

import struct
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from latticeurbanwind_tpu.io import xls as JX
from latticeurbanwind_tpu.post import aij_casee as JA
from latticeurbanwind_tpu_torch.io import xls as TX
from latticeurbanwind_tpu_torch.post import aij_casee as TA

END, FREE = 0xFFFFFFFE, 0xFFFFFFFF
SHEETS = ("Geometry&Points", "Inflow", "Results (Before Construction)",
          "Results (After Construction)")


def _rec(rid, body):
    return struct.pack("<HH", rid, len(body)) + body


def _number(r, c, v):
    return _rec(0x0203, struct.pack("<HHH", r, c, 0) + struct.pack("<d", v))


def _rk_int(v):
    return ((v & 0x3FFFFFFF) << 2 | 2) & 0xFFFFFFFF


def test_decode_rk_variants():
    cases = [(42 << 2) | 2, _rk_int(-7), ((150 << 2) | 2) | 1]
    bits = struct.unpack("<Q", struct.pack("<d", 2.5))[0]
    cases += [(bits >> 32) & 0xFFFFFFFC, ((bits >> 32) & 0xFFFFFFFC) | 1]
    assert [TX._decode_rk(v) for v in cases] == [JX._decode_rk(v) for v in cases] \
        == [42.0, -7.0, 1.5, 2.5, 0.025]


def test_biff_records_and_sst():
    sst_body = struct.pack("<II", 2, 2) + struct.pack("<HB", 5, 0) + b"hello" \
        + struct.pack("<HB", 3, 1) + "abc".encode("utf-16-le")
    stream = b"".join([
        # the CONTINUE re-states the split string's encoding in its first byte
        _rec(0x00FC, sst_body[:14]), _rec(0x003C, b"\x00" + sst_body[14:]),
        _number(0, 0, 3.25),
        _rec(0x027E, struct.pack("<HHHI", 0, 1, 0, (9 << 2) | 2)),
        _rec(0x00BD, struct.pack("<HH", 1, 0) + struct.pack("<HI", 0, (10 << 2) | 2)
             + struct.pack("<HI", 0, (20 << 2) | 2) + struct.pack("<H", 1)),
        _rec(0x00FD, struct.pack("<HHHI", 2, 0, 0, 0)),
    ])
    assert list(TX._records(stream)) == list(JX._records(stream))
    bodies = next(b for r, b in TX._records(stream) if r == 0x00FC)
    assert len(bodies) == 2
    assert TX._parse_sst(bodies) == JX._parse_sst(bodies) == ["hello", "abc"]
    # a wide string split across a CONTINUE boundary
    part1 = struct.pack("<II", 1, 1) + struct.pack("<HB", 6, 1) \
        + "abc".encode("utf-16-le")
    part2 = b"\x01" + "def".encode("utf-16-le")
    assert TX._parse_sst([part1, part2]) == JX._parse_sst([part1, part2]) == ["abcdef"]


def write_workbook(path: Path, sheets: dict) -> None:
    """A BIFF8 workbook of NUMBER / RK / MULRK / LABELSST cells in a CFB v3
    container (one FAT sector, the stream in regular sectors)."""
    sst = []

    def sst_index(s):
        if s not in sst:
            sst.append(s)
        return sst.index(s)

    subs = []
    for cells in sheets.values():
        recs = [_rec(0x0809, struct.pack("<HH", 0x0600, 0x10) + bytes(12))]
        rows = {}
        for (r, c), v in sorted(cells.items()):
            rows.setdefault(r, []).append((c, v))
        for r, items in rows.items():
            ints = [(c, v) for c, v in items if isinstance(v, int)]
            if len(ints) >= 2 and [c for c, _ in ints] == list(
                    range(ints[0][0], ints[0][0] + len(ints))):
                recs.append(_rec(0x00BD, struct.pack("<HH", r, ints[0][0]) + b"".join(
                    struct.pack("<HI", 0, _rk_int(v)) for _, v in ints)
                    + struct.pack("<H", ints[-1][0])))
                items = [(c, v) for c, v in items if not isinstance(v, int)]
            for c, v in items:
                if isinstance(v, str):
                    recs.append(_rec(0x00FD, struct.pack("<HHHI", r, c, 0, sst_index(v))))
                elif isinstance(v, int):
                    recs.append(_rec(0x027E, struct.pack("<HHHI", r, c, 0, _rk_int(v))))
                else:
                    recs.append(_number(r, c, v))
        recs.append(_rec(0x000A, b""))
        subs.append(b"".join(recs))
    sst_body = struct.pack("<II", len(sst), len(sst)) + b"".join(
        struct.pack("<HB", len(s), 0) + s.encode("latin-1") for s in sst)
    names = [n.encode("latin-1") for n in sheets]
    head = _rec(0x0809, struct.pack("<HH", 0x0600, 0x05) + bytes(12))
    tail = _rec(0x00FC, sst_body) + _rec(0x000A, b"")
    glob_len = len(head) + sum(4 + 8 + len(n) for n in names) + len(tail)
    offsets = np.cumsum([glob_len] + [len(s) for s in subs])[:-1]
    stream = head + b"".join(
        _rec(0x0085, struct.pack("<IBBBB", int(o), 0, 0, len(n), 0) + n)
        for o, n in zip(offsets, names)) + tail + b"".join(subs)
    stream += bytes(max(0, 4096 - len(stream)))
    n = -(-len(stream) // 512)
    fat = [0xFFFFFFFD] + [i + 2 for i in range(n - 1)] + [END, END]
    fat += [FREE] * (128 - len(fat))
    header = bytearray(512)
    header[:8] = b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1"
    struct.pack_into("<HHHHH", header, 24, 0x3E, 3, 0xFFFE, 9, 6)
    struct.pack_into("<IIIIIIIII", header, 40, 0, 1, n + 1, 0, 4096, END, 0, END, 0)
    struct.pack_into("<109I", header, 76, 0, *([FREE] * 108))

    def entry(name, typ, start, size):
        e = bytearray(128)
        raw = name.encode("utf-16-le")
        e[:len(raw)] = raw
        struct.pack_into("<HBB", e, 64, len(raw) + 2, typ, 1)
        struct.pack_into("<III", e, 68, FREE, FREE, 1 if typ == 5 else FREE)
        struct.pack_into("<II", e, 116, start, size)
        return bytes(e)

    directory = entry("Root Entry", 5, END, 0) + entry("Workbook", 2, 1, len(stream))
    directory += bytes(512 - len(directory))
    path.write_bytes(bytes(header) + struct.pack("<128I", *fat)
                     + stream.ljust(n * 512, b"\0") + directory)


def casee_workbook(path: Path, seed=0, n=80) -> None:
    """A seeded workbook with the Case E sheets' layout."""
    rng = np.random.default_rng(seed)
    geo = {(0, 1): "No.", (0, 2): "x (m)", (0, 3): "y (m)"}
    for i in range(n):
        geo[(i + 2, 1)] = float(i + 1)
        geo[(i + 2, 2)], geo[(i + 2, 3)] = (float(v) for v in
                                            np.round(rng.uniform(-200, 200, 2), 2))
    inflow = {(0, 1): "z/ZR", (0, 2): "U/UR", (0, 3): "k/UR2"}
    for j, z in enumerate((0.005, 0.05, 0.2, 0.5, 1.0)):
        inflow[(j + 1, 1)], inflow[(j + 1, 2)] = z, float(z ** 0.25)
        inflow[(j + 1, 3)] = 0.01
    sheets = {SHEETS[0]: geo, SHEETS[1]: inflow}
    for name in SHEETS[2:]:
        res = {(1, 2 + d): c for d, c in enumerate(JA.COMPASS16)}
        for i in range(n):
            res[(i + 2, 1)] = i + 1 if i % 2 else float(i + 1)
            for d in range(16):
                res[(i + 2, 2 + d)] = float(np.round(rng.uniform(0.1, 1.4), 3))
        sheets[name] = res
    write_workbook(path, sheets)


def test_load_xls_and_casee(tmp_path):
    path = tmp_path / "CaseE.xls"
    casee_workbook(path)
    wt, wj = TX.load_xls(path), JX.load_xls(path)
    assert wt.sheet_names == wj.sheet_names == list(SHEETS)
    assert wt.sheets == wj.sheets
    for name in SHEETS:
        assert wt.rows(name) == wj.rows(name)
    assert wt.rows("inflow") == wj.rows("Inflow")
    with pytest.raises(KeyError):
        wt.sheet("nope")
    dt, dj = TA.load_aij_casee(path), JA.load_aij_casee(path)
    for f in ("point_no", "points", "inflow_z_zr", "inflow_u_ur", "inflow_k_ur2"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    assert dt.points.shape == (80, 2)
    for v in ("before", "after"):
        np.testing.assert_array_equal(dt.ratios[v], dj.ratios[v])
        assert np.isfinite(dt.ratios[v]).all()
    for mod in (TX, JX):
        with pytest.raises(ValueError):
            mod._ole2_stream(b"x" * 600, "Workbook")
        with pytest.raises(KeyError):
            mod._ole2_stream(path.read_bytes(), "Book")


def test_compass_sampling_and_stats():
    angles = (0, 90, 180, 270, 22.5, 359, -90, 11.24, 11.26, 720.5)
    assert [TA.compass_column(a) for a in angles] == [JA.compass_column(a) for a in angles]
    sp, Z = 4.0, 8
    origin = (sp * (0.5 - Z / 2),) * 3
    meta = {"origin": origin, "spacing": (sp, sp, sp)}
    rng = np.random.default_rng(2)
    u = rng.uniform(-3, 3, (3, Z, Z, Z)).astype(np.float32)
    fluid = (rng.random((Z, Z, Z)) > 0.2).astype(np.float32)
    pts = np.concatenate([rng.uniform(-14, 14, (40, 2)), [[1e5, 0.0], [0.0, 0.0]]])
    for fields in ({"u_avg": u, "fluid": fluid}, {"u_avg": u}):
        for base in (0.0, 4.0, 9.0):
            a = TA.sample_ratios(meta, fields, pts, 10.0, base)
            b = JA.sample_ratios(meta, fields, pts, 10.0, base)
            np.testing.assert_array_equal(a, b)
    m = rng.uniform(0.1, 1.2, 50)
    for c in (m.copy(), m + 0.1, m * rng.uniform(0.5, 1.5, 50), np.full(50, np.nan)):
        c[::7] = np.nan
        assert repr(TA.compare(m, c)) == repr(JA.compare(m, c))   # NaN too
    z = np.array([1.25, 12.5, 125.0, 250.0])
    uu = np.array([2.847, 3.7674, 6.5, 7.8])
    assert TA.reference_speed(z, uu) == JA.reference_speed(z, uu)
    assert TA.reference_speed(z / 250, uu, domain_agl_m=250.0) == \
        JA.reference_speed(z / 250, uu, domain_agl_m=250.0)
    for mod in (TA, JA):
        with pytest.raises(ValueError):
            mod.reference_speed(z / 250.0, uu)


def test_validate_deck_on_a_seeded_case(tmp_path, monkeypatch, capsys):
    """`luwaij` on a two-angle profile case with its averaged VTKs: both
    packages' statistics, CSV and figure names."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.figure

    from latticeurbanwind_tpu.io.vtk import write_structured_points
    from latticeurbanwind_tpu_torch.io.png import png_size

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, f, *a, **k: Path(f).write_bytes(b""))
    dt = "20260101120000"
    rng = np.random.default_rng(9)
    sp, Z, Y, X = 10.0, 8, 60, 60
    fluid = np.ones((Z, Y, X), np.float32)
    fluid[:2] = 0.0
    fluid[2:6, 25:35, 25:35] = 0.0
    out = {}
    for side, mod in (("jax", JA), ("port", TA)):
        home = tmp_path / side
        (home / "wind_bc").mkdir(parents=True)
        (home / "RESULTS" / "vtk").mkdir(parents=True)
        (home / "wind_bc" / "profile.dat").write_text(
            "z,U\n1.25\t2.847\n12.5\t3.7674\n125\t6.5\n250\t7.8\n")
        (home / "conf.luwpf").write_text(
            f"casename = e\ndatetime = {dt}\nbase_height = 20\n"
            "si_z_cfd = [0, 80]\nangle = [0, 90]\n")
        casee_workbook(home / "CaseE(test).xls", seed=3)
        r = np.random.default_rng(9)
        for a in (0, 90):
            u = r.uniform(0.5, 4.0, (3, Z, Y, X)).astype(np.float32) * fluid
            write_structured_points(home / "RESULTS" / "vtk" /
                                    f"ANG_{a}_{dt}_avg-000000100.vtk",
                                    {"u_avg": u, "fluid": fluid}, spacing=sp)
        rc = mod.main([str(home / "conf.luwpf"), "--angles", "0,90,45"])
        out[side] = (rc, capsys.readouterr().out.replace(str(home), "<case>"))
    assert out["port"] == out["jax"] and out["port"][0] == 0
    assert "OVERALL (after)" in out["port"][1]
    same = [(tmp_path / s / "RESULTS" / "aij_casee_after.csv").read_bytes()
            for s in ("jax", "port")]
    assert same[0] == same[1]
    names = [sorted(p.name for p in (tmp_path / s / "RESULTS").glob("*.png"))
             for s in ("jax", "port")]
    assert names[0] == names[1] == ["aij_casee_after.png", "aij_casee_map_after.png"]
    for n in names[1]:
        assert min(png_size(tmp_path / "port" / "RESULTS" / n)) > 0
    res = [mod.validate_deck(tmp_path / s / "conf.luwpf", tmp_path / s / "CaseE(test).xls",
                             variant="before", make_figure=False)
           for s, mod in (("jax", JA), ("port", TA))]
    capsys.readouterr()
    assert repr(res[0]["angles"]) == repr(res[1]["angles"])
    assert repr(res[0]["overall"]) == repr(res[1]["overall"])
    assert res[0]["u_ref"] == res[1]["u_ref"]
    assert TA.main([str(tmp_path / "port" / "missing" / "conf.luwpf")]) == 2
