"""PyTorch port, `luwvideo` (`post/video.py`) against the JAX package:
`tests/test_video.py`'s six cases through both packages.

Series discovery, the field blend and the decimation are held exactly;
the frames by count, names and, for the `slice` / `mip` modes (matplotlib
in the JAX package, `io/figure.py` in the port), each port PNG read back
through `png_size`; the `3d` / `volume` frames come from
`run/render.py::render_scene` in both packages.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from latticeurbanwind_tpu.io.vtk import write_structured_points
from latticeurbanwind_tpu.post import video as J
from latticeurbanwind_tpu_torch.io.png import png_size
from latticeurbanwind_tpu_torch.post import video as T

REPO = Path(__file__).resolve().parents[1]


def _series(d: Path, n_steps=3, mag0=1.0):
    Z, Y, X = 6, 10, 12
    d.mkdir(parents=True, exist_ok=True)
    files = []
    for i in range(n_steps):
        u = np.full((3, Z, Y, X), mag0 + i, np.float32)
        u[:, :, :, : X // 2] *= 0.5
        f = d / f"demo_raw_u-{(i + 1) * 10:09d}.vtk"
        write_structured_points(f, {"u": u}, spacing=5.0)
        files.append(f)
    return files


@pytest.fixture
def fast_mpl(monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.figure

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, f, *a, **k: Path(f).write_bytes(b""))


def _frames(d: Path):
    return sorted(p.name for p in d.glob("frame_*.png"))


def test_discover_series_sorts_by_step(tmp_path):
    files = _series(tmp_path)
    write_structured_points(tmp_path / "other_avg-000000005.vtk",
                            {"u": np.zeros((3, 2, 2, 2), np.float32)})
    write_structured_points(tmp_path / "demo_raw_u_x-000000001.vtk",
                            {"u": np.zeros((3, 2, 2, 2), np.float32)})
    for f in (*files, tmp_path / "noseries.vtk", tmp_path / "other_avg-000000005.vtk"):
        assert T.discover_series(f) == J.discover_series(f)
    assert T.discover_series(files[1]) == files


def test_lerp_and_decimate():
    rng = np.random.default_rng(0)
    fa = {"u": rng.normal(size=(3, 4, 5, 6)).astype(np.float32),
          "rho": rng.normal(size=(4, 5, 6)).astype(np.float32),
          "odd": np.zeros((2, 2), np.float32)}
    fb = {"u": rng.normal(size=(3, 4, 5, 6)).astype(np.float32),
          "rho": rng.normal(size=(4, 5, 6)).astype(np.float32)}
    for t in (0.0, 0.25, 0.5, 1.0):
        a, b = T.lerp_fields(fa, fb, t), J.lerp_fields(fa, fb, t)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    big = {"u": np.zeros((3, 130, 130, 130), np.float32),
           "fluid": np.ones((130, 130, 130), np.float32)}
    for f in (big, fa):
        (a, sa), (b, sb) = T._decimate(f), J._decimate(f)
        assert sa == sb and {k: v.shape for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}
    assert T._decimate(big)[1] == 2


def test_export_frames_with_interpolation(tmp_path, fast_mpl):
    out = {}
    for side, mod in (("jax", J), ("port", T)):
        files = _series(tmp_path / side, n_steps=3)
        frames = mod.export_frames(files[0], tmp_path / side / "video", mode="slice",
                                   z=2, interp=2)
        out[side] = [p.name for p in frames]
    assert out["port"] == out["jax"] == [f"frame_{i:05d}.png" for i in range(7)]
    for name in out["port"]:
        assert png_size(tmp_path / "port" / "video" / name)[0] > 100


def test_export_frames_3d_and_volume(tmp_path):
    for mode in ("3d", "volume"):
        names = {}
        for side, mod in (("jax", J), ("port", T)):
            files = _series(tmp_path / side, n_steps=2)
            frames = mod.export_frames(files[0], tmp_path / side / f"v_{mode}", mode=mode)
            names[side] = [p.name for p in frames]
        assert names["port"] == names["jax"] == ["frame_00000.png", "frame_00001.png"]
        for n in names["port"]:
            assert png_size(tmp_path / "port" / f"v_{mode}" / n) == (820, 600)


def test_video_cli(tmp_path, fast_mpl, capsys):
    for side, mod in (("jax", J), ("port", T)):
        files = _series(tmp_path / side, n_steps=2)
        assert mod.main([str(files[0]), "--mode", "mip", "--interp", "1",
                         "--out-dir", str(tmp_path / side / "clip")]) == 0
        assert mod.main([str(tmp_path / side / "missing.vtk")]) == 1
    assert _frames(tmp_path / "port" / "clip") == _frames(tmp_path / "jax" / "clip")
    assert len(_frames(tmp_path / "port" / "clip")) == 3
    out = capsys.readouterr().out
    assert out.count("wrote 3 frames") == 2 and out.count("ERROR") == 2


def test_video_via_dispatch(tmp_path):
    """The luwvideo command resolves through the port's dispatch table."""
    files = _series(tmp_path, n_steps=2)
    r = subprocess.run(
        [sys.executable, "-m", "latticeurbanwind_tpu_torch.cli.dispatch",
         "luwvideo", files[0].name, "--mode", "slice"],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ffmpeg" in r.stdout
    frames = sorted((tmp_path / "video_demo_raw_u").glob("*.png"))
    assert [p.name for p in frames] == ["frame_00000.png", "frame_00001.png"]
