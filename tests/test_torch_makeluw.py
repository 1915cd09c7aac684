"""PyTorch port, the pre-processing pipeline (`cli/makeluw.py` and its six
stages, `cli/dispatch.py`) against `examples/example_NWP-LBM_prepared/` and
the JAX package's `makeluw`.

  * The port's makeluw on a copy of `examples/example_NWP-LBM` writes
    `conf.luw`, the SurfData CSV and the case STL byte for byte as the
    prepared example holds them, and `buildings.csv`,
    `interpolated_dem.csv` and the cropped shapefile byte for byte as the
    JAX package's makeluw writes them on another copy.
  * A DEM variant (a seeded hill as a `lon,lat,elev` CSV through luwdem,
    `terr_voxel_approach = kriging_gpu`) runs with `--device cpu`: the STL
    vertices are within 1e-3 m of the JAX run's (both solve in float32,
    with different LU codes); with `--device cuda` and no card the
    pipeline fails at luwvox instead of solving on the CPU.
  * Every dispatch target is a module of the port.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "example_NWP-LBM"
PREPARED = REPO / "examples" / "example_NWP-LBM_prepared"
MADE = ["conf.luw", "proj_temp/SurfData_20260101120000.csv",
        "proj_temp/NwpDemo_DG.stl"]
CROPPED = ["proj_temp/buildings.csv", "proj_temp/interpolated_dem.csv"] + [
    f"proj_temp/NwpDemo_buildings.{e}" for e in ("shp", "shx", "dbf")]


def _makeluw_both(tmp_path: Path, prepare=None, port_args=("--device", "cpu")):
    from latticeurbanwind_tpu.cli.makeluw import main as jax_makeluw
    from latticeurbanwind_tpu_torch.cli.dispatch import main as dispatch

    homes = {}
    for side in ("jax", "port"):
        home = tmp_path / side
        shutil.copytree(EXAMPLE, home)
        if prepare is not None:
            prepare(home, side)
        if side == "jax":
            assert jax_makeluw([str(home / "conf.luw")]) == 0
        else:
            assert dispatch(["makeluw", str(home / "conf.luw"), *port_args]) == 0
        homes[side] = home
    return homes["jax"], homes["port"]


def test_makeluw_example_matches_prepared_and_jax(tmp_path):
    jax_home, home = _makeluw_both(tmp_path)
    for name in MADE:
        assert (home / name).read_bytes() == (PREPARED / name).read_bytes(), name
    for name in CROPPED:
        assert (home / name).read_bytes() == (jax_home / name).read_bytes(), name
    (log,) = sorted((home / "proj_temp").glob("*.log"))
    text = log.read_text()
    for stage in ("cdfinspect", "shpinspect", "luwbc", "luwcut", "luwvox", "luwval"):
        assert f"[{stage}] stage seconds: " in text
    assert "Validation passed" in text
    assert (home / "proj_temp" / "NwpDemo_buildings.png").exists()


def _hill(home: Path, side: str):
    from latticeurbanwind_tpu_torch.deck import load_deck

    rng = np.random.default_rng(21)
    n = 2500
    lon = rng.uniform(121.304, 121.344, n)
    lat = rng.uniform(31.104, 31.136, n)
    elev = 80.0 * np.exp(-(((lon - 121.324) / 0.01) ** 2
                           + ((lat - 31.12) / 0.008) ** 2)) + rng.normal(0, 1.0, n)
    (home / "database").mkdir()
    np.savetxt(home / "database" / "hill_dem.csv",
               np.column_stack([lon, lat, elev]), delimiter=",",
               header="lon,lat,elev", comments="", fmt="%.8f")
    deck = load_deck(home / "conf.luw")
    deck.set_text("terr_voxel_approach", "kriging_gpu", quoted=True)
    deck.save()
    if side == "jax":
        from latticeurbanwind_tpu.pre.dem_ingest import main as luwdem
    else:
        from latticeurbanwind_tpu_torch.pre.dem_ingest import main as luwdem
    assert luwdem([str(home / "conf.luw")]) == 0


def test_makeluw_dem_kriging_gpu_on_cpu_matches_jax(tmp_path):
    from latticeurbanwind_tpu_torch.geometry import read_stl

    jax_home, home = _makeluw_both(tmp_path, _hill)
    stl = "proj_temp/NwpDemo_DG.stl"
    got, ref = read_stl(home / stl).tris, read_stl(jax_home / stl).tris
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.float64) - ref).max() < 1e-3
    dem = np.loadtxt(home / "proj_temp" / "interpolated_dem.csv",
                     delimiter=",", skiprows=1)
    dem_j = np.loadtxt(jax_home / "proj_temp" / "interpolated_dem.csv",
                       delimiter=",", skiprows=1)
    assert dem[:, 2].max() > 40.0
    assert np.abs(dem - dem_j).max() < 1e-3
    log = next((home / "proj_temp").glob("*.log")).read_text()
    assert "terrain: kriging_gpu on 2500 DEM points" in log
    for name in ("conf.luw", "proj_temp/SurfData_20260101120000.csv"):
        assert (home / name).read_bytes() == (jax_home / name).read_bytes()


def test_makeluw_on_cuda_without_a_card_fails_at_luwvox(tmp_path, monkeypatch,
                                                         capsys):
    from latticeurbanwind_tpu_torch.cli.makeluw import main as makeluw

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    home = tmp_path / "nocard"
    shutil.copytree(EXAMPLE, home)
    _hill(home, "port")
    assert makeluw([str(home / "conf.luw")]) == 1
    out = capsys.readouterr().out
    assert "FAILED at stage luwvox" in out
    log = next((home / "proj_temp").glob("*.log")).read_text()
    assert "[luwvox] ERROR: RuntimeError: no CUDA device" in log
    assert not (home / "proj_temp" / "NwpDemo_DG.stl").exists()
    assert makeluw([]) == 2
    assert makeluw([str(home / "missing.luw")]) == 1


def test_dispatch_targets_are_port_modules(capsys):
    import importlib

    from latticeurbanwind_tpu_torch.cli.dispatch import COMMANDS, main

    assert sorted(COMMANDS) == sorted([
        "makeluw", "runluw", "luwbc", "luwcut", "luwvox", "luwdem", "luwval",
        "cdfinspect", "shpinspect", "cleanluw", "luwenv", "vtk2nc"])
    for cmd, handler in COMMANDS.items():
        modname, attr = handler.target
        assert modname.startswith("latticeurbanwind_tpu_torch."), cmd
        assert callable(getattr(importlib.import_module(modname), attr)), cmd
    assert COMMANDS["runluw"].target[0] == "latticeurbanwind_tpu_torch.cli.run"
    for argv in (["visluw", "conf.luw"], ["luwstudio"]):
        assert main(argv) == 2
        out = capsys.readouterr().out
        assert f"Unknown command: {argv[0]}" in out and "makeluw" in out
    assert main([]) == 2


def test_luwenv_reports_the_cuda_environment(capsys):
    import json

    from latticeurbanwind_tpu_torch.cli.dispatch import main
    from latticeurbanwind_tpu_torch.utils.accelerator import probe_cuda_environment

    rep = probe_cuda_environment()
    assert rep["torch"] == torch.__version__
    assert rep["cuda_available"] == torch.cuda.is_available()
    assert len(rep["devices"]) == (torch.cuda.device_count()
                                   if torch.cuda.is_available() else 0)
    assert rep["kernel_build_dir"].endswith("_build")
    assert rep["kernel_library"]["path"].endswith(".so")
    if rep["nvcc"] is None:
        assert any(e.startswith("nvcc:") for e in rep["errors"])
    assert main(["luwenv"]) == 0
    out = capsys.readouterr().out
    parsed = json.loads(out[out.index("{"):])
    assert parsed["torch"] == torch.__version__


@pytest.mark.parametrize("cmd", ["makeluw", "luwvox"])
def test_cli_device_option_reaches_the_solve(tmp_path, cmd, monkeypatch):
    """`--device` goes from makeluw (or luwvox alone) to the kriging solve."""
    from latticeurbanwind_tpu_torch.cli.dispatch import main as dispatch
    from latticeurbanwind_tpu_torch.pre import terrain

    seen = []
    real = terrain.solve_systems

    def spy(A, b, device):
        seen.append(str(device))
        return real(A, b, "cpu")

    monkeypatch.setattr(terrain, "solve_systems", spy)
    home = tmp_path / cmd
    shutil.copytree(PREPARED if cmd == "luwvox" else EXAMPLE, home)
    _hill(home, "port")
    assert dispatch([cmd, str(home / "conf.luw"), "--device", "cuda:3"]) == 0
    assert seen == ["cuda:3"]
