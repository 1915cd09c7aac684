"""PyTorch port, the flagship route end to end: synthetic WRF NetCDF ->
makeluw -> the patch-2D standard-mode solve -> vtk2nc, through the port
alone, against the JAX package on the same case.

The case is `tests/test_e2e_nwp.py`'s fixture (40 m cells, 30 steps; the
fixture, imported from there, builds it once and it is copied for each
package) with `lbm_storage = f32`, so that the solve can be held to the
tolerances `tests/test_torch_standard_mode.py` uses for `.luw` decks.  The
JAX package runs `makeluw`, `run_deck(impl="pallas")` in interpret mode and
`vtk2nc`; the port runs `dispatch makeluw --device cpu`,
`run_deck(device="cpu")` and `dispatch vtk2nc`.

  * The prepared files (deck, SurfData CSV, buildings.csv,
    interpolated_dem.csv, the case STL) are byte for byte equal.
  * The VTKs: flags and initial fields equal, the averaged and raw fields
    within the standard-mode tolerances (u 2e-3 m/s, rho 1e-4, T 2e-3 K,
    tke 1e-4, TI and TLS 2e-3 relative).
  * The NetCDF files: the same names, variables and axes (equal), every
    variable within the tolerance of the VTK field it was regridded from.
  * The JAX test's own assertions on the port's run: the patch column,
    `validation = pass`, SI winds above 1 m/s.
"""

import shutil

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from tests.test_e2e_nwp import nwp_case  # noqa: F401 (the fixture)
from tests.test_torch_standard_mode import _compare_outputs, _run_both

PREPARED_FILES = ["conf.luw", "proj_temp/SurfData_20251010120000.csv",
                  "proj_temp/buildings.csv", "proj_temp/interpolated_dem.csv",
                  "proj_temp/nwp_DG.stl"]
NC_TOL = {"ue": 2e-3, "vn": 2e-3, "w": 2e-3, "u_avg": 2e-3, "rho_avg": 1e-4,
          "T_avg": 2e-3, "tke": 1e-4}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _read_nc(path):
    from scipy.io import netcdf_file

    with netcdf_file(str(path), "r", mmap=False) as nc:
        return {k: np.array(v[:]) for k, v in nc.variables.items()}


def _nc_tolerance(file_name: str, var: str):
    """(rtol, atol) of a NetCDF variable: its VTK field's."""
    if var in ("TI", "TLS"):
        return 2e-3, 1e-5
    if var == "data":                 # a raw scalar file: rho or T
        return 0.0, 1e-4 if "_raw_rho-" in file_name else 2e-3
    return 0.0, NC_TOL[var]


def test_nwp_pipeline_to_netcdf_through_the_port(nwp_case, tmp_path, monkeypatch):  # noqa: F811
    from latticeurbanwind_tpu.cli.makeluw import main as jax_makeluw
    from latticeurbanwind_tpu.post.vtk2nc import main as jax_vtk2nc
    from latticeurbanwind_tpu_torch.cli.dispatch import main as dispatch
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.io.vtk import read_structured_points

    homes = {}
    for side in ("jax", "port"):
        home = tmp_path / side
        shutil.copytree(nwp_case, home)
        with open(home / "conf.luw", "a") as fh:
            fh.write("lbm_storage = f32\n")
        deck = str(home / "conf.luw")
        if side == "jax":
            assert jax_makeluw([deck]) == 0
        else:
            assert dispatch(["makeluw", deck, "--device", "cpu"]) == 0
        homes[side] = home
    for name in PREPARED_FILES:
        assert (homes["port"] / name).read_bytes() == \
            (homes["jax"] / name).read_bytes(), name

    # the JAX test's own checks, on the port's pipeline
    home = homes["port"]
    csv = home / "proj_temp" / "SurfData_20251010120000.csv"
    assert csv.read_text().splitlines()[0].endswith(",patch")
    deck = load_deck(home / "conf.luw")
    assert deck.get_text("validation") == "pass"
    assert deck.get_text("downstream_bc")

    got, ref, port_init, jax_init = _run_both(
        monkeypatch, homes["jax"] / "conf.luw", home / "conf.luw")
    assert got.total_steps == 30
    _compare_outputs(got, ref, port_init, jax_init)
    (avg,) = [p for p in got.files if "_avg-" in p.name]
    _, fields = read_structured_points(avg)
    assert np.isfinite(fields["u_avg"]).all()
    speed = np.linalg.norm(fields["u_avg"], axis=0)
    assert speed[fields["fluid"] > 0.5].max() > 1.0

    assert jax_vtk2nc([str(homes["jax"] / "conf.luw")]) == 0
    assert dispatch(["vtk2nc", str(home / "conf.luw")]) == 0
    ncs = {side: sorted((h / "RESULTS").glob("*.nc")) for side, h in homes.items()}
    assert [p.name for p in ncs["port"]] == [p.name for p in ncs["jax"]]
    assert len(ncs["port"]) == len([p for p in got.files if p.suffix == ".vtk"])
    for pg, pr in zip(ncs["port"], ncs["jax"]):
        g, r = _read_nc(pg), _read_nc(pr)
        assert sorted(g) == sorted(r), pg.name
        for axis in ("lon", "lat", "z"):
            np.testing.assert_array_equal(g[axis], r[axis])
        for var in sorted(set(g) - {"lon", "lat", "z"}):
            assert np.isfinite(g[var]).all(), (pg.name, var)
            rtol, atol = _nc_tolerance(pg.name, var)
            np.testing.assert_allclose(g[var], r[var], rtol=rtol, atol=atol,
                                       err_msg=f"{pg.name}:{var}")
