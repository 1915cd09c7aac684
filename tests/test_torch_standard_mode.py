"""PyTorch port: the standard NWP-coupled run mode (.luw) against the JAX
package.

The BC interpolators are held to the JAX package's own tests
(tests/test_standard_mode.py:20-83) and to its functions on seeded inputs.
The decks -- the three synthetic ones of tests/test_standard_mode.py
(nearest, high-order, patch; 20x20x~13 cells, 30 steps) and the prepared NWP
example at a coarse cell size -- run through both packages: the JAX one
with `impl="pallas"` in interpret mode (the pure-DDF tier the port follows),
the port on the CPU, both with `lbm_storage = f32`.

Tolerances on the outputs (SI units): the set-up is the same numpy code, so
flags and the initial u and T must be equal (nearest: the neighbour search
runs in torch, same float32 formula); after the steps u_avg and raw u agree
to 2e-3 m/s (lattice 3e-5 at si_u ~ 60-100 m/s per lattice unit, the
kernels' f32 tolerance summed over the steps), rho to 1e-4 kg/m^3, and
temperatures to 2e-3 K (float32 Kelvin near 290 resolves 3e-5 K).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
PREPARED = REPO / "examples" / "example_NWP-LBM_prepared"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


# ---- (d) the interpolators --------------------------------------------------

def test_read_surfdata_named_and_positional(tmp_path):
    from latticeurbanwind_tpu.bc.samples import read_surfdata_csv as jax_read
    from latticeurbanwind_tpu_torch.bc.samples import read_surfdata_csv

    named = tmp_path / "named.csv"
    named.write_text("X,Y,Z,u,v,w,T,patch\n0,0,10,1,2,0,290,2\n100,0,10,2,1,0,295,3\n")
    s = read_surfdata_csv(named)
    assert s.has_temperature and s.has_patch
    assert s.max_speed == pytest.approx(np.sqrt(5))
    assert s.temperature_range() == (290.0, 295.0)
    legacy = tmp_path / "legacy.csv"
    legacy.write_text("x,y,z,u,v,w\n0,0,10,1,0,0\n")
    s2 = read_surfdata_csv(legacy)
    assert not s2.has_temperature and not s2.has_patch
    # the prepared deck's CSV reads as the JAX package reads it
    csv = PREPARED / "proj_temp" / "SurfData_20260101120000.csv"
    a, b = read_surfdata_csv(csv), jax_read(csv)
    assert len(a.p) == 7392 and a.has_patch and a.has_temperature
    for name in ("p", "u", "T", "patch"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_nearest_neighbor_matches_bruteforce_and_jax():
    from latticeurbanwind_tpu.bc.nearest import nearest_neighbor_eval as jax_nn
    from latticeurbanwind_tpu_torch.bc.nearest import nearest_neighbor_eval

    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 100, (500, 3))
    vals = rng.standard_normal((500, 3))
    q = rng.uniform(0, 100, (200, 3))
    got = nearest_neighbor_eval(pts, vals, q)
    d2 = ((q[:, None, :] - pts[None]) ** 2).sum(axis=2)
    np.testing.assert_allclose(got, vals[d2.argmin(axis=1)])
    np.testing.assert_array_equal(got, jax_nn(pts, vals, q))
    # chunked, and the empty sample set
    np.testing.assert_array_equal(nearest_neighbor_eval(pts, vals, q, chunk=64),
                                  got)
    assert nearest_neighbor_eval(np.zeros((0, 3)), np.zeros((0, 3)), q).shape == (200, 3)


def test_hd_interpolator_reproduces_smooth_plane_field():
    """Quadratic LSQ must reproduce a linear field on a plane exactly."""
    from latticeurbanwind_tpu.bc.high_order import KNNInterpolatorHD as JaxHD
    from latticeurbanwind_tpu_torch.bc.high_order import KNNInterpolatorHD

    rng = np.random.default_rng(1)
    n = 400
    y = rng.uniform(0, 100, n)
    z = rng.uniform(0, 50, n)
    pts = np.stack([np.zeros(n), y, z], axis=1)
    vals = np.stack([2.0 + 0.03 * y + 0.05 * z, 0.1 * z, np.zeros(n)], axis=1)
    interp = KNNInterpolatorHD(pts, vals)
    q = np.array([[0.0, 50.0, 25.0], [0.0, 20.0, 10.0]])
    got = interp.eval(q)
    expect = np.stack([2.0 + 0.03 * q[:, 1] + 0.05 * q[:, 2],
                       0.1 * q[:, 2], np.zeros(2)], axis=1)
    np.testing.assert_allclose(got, expect, rtol=5e-3, atol=1e-3)
    qs = np.stack([np.zeros(50), rng.uniform(0, 100, 50),
                   rng.uniform(0, 50, 50)], axis=1)
    np.testing.assert_array_equal(interp.eval(qs), JaxHD(pts, vals).eval(qs))


def test_hd_exact_hit_returns_sample():
    from latticeurbanwind_tpu_torch.bc.high_order import KNNInterpolatorHD

    pts = np.array([[0.0, 1.0, 2.0], [0.0, 5.0, 6.0], [0.0, 9.0, 3.0],
                    [0.0, 2.0, 8.0], [0.0, 7.0, 7.0], [0.0, 4.0, 4.0],
                    [0.0, 3.0, 1.0]])
    vals = np.arange(7, dtype=np.float64)[:, None]
    got = KNNInterpolatorHD(pts, vals).eval(np.array([[0.0, 5.0, 6.0]]))
    assert got[0, 0] == pytest.approx(1.0)


def test_patch_field_bilinear_structured():
    from latticeurbanwind_tpu.bc.patch2d import PatchField2D as JaxField
    from latticeurbanwind_tpu_torch.bc.patch2d import PatchField2D

    a, b = np.meshgrid(np.arange(4) * 10.0, np.arange(5) * 5.0, indexing="ij")
    vals = (2 * a + 3 * b).ravel()[:, None]
    f = PatchField2D(a.ravel(), b.ravel(), vals)
    got = f.eval(np.array([15.0]), np.array([7.5]))
    assert got[0, 0] == pytest.approx(2 * 15 + 3 * 7.5)
    assert f.eval(np.array([-5.0]), np.array([0.0]))[0, 0] == pytest.approx(0.0)
    assert f.eval(np.array([35.0]), np.array([25.0]))[0, 0] == pytest.approx(2 * 30 + 3 * 20)
    assert not f.below_sample_support(np.array([15.0]), np.array([0.0]))[0]
    assert f.below_sample_support(np.array([15.0]), np.array([-1.0]))[0]
    rng = np.random.default_rng(2)
    qa, qb = rng.uniform(-5, 40, 64), rng.uniform(-3, 25, 64)
    jf = JaxField(a.ravel(), b.ravel(), vals)
    np.testing.assert_array_equal(f.eval(qa, qb), jf.eval(qa, qb))
    np.testing.assert_array_equal(f.below_sample_support(qa, qb),
                                  jf.below_sample_support(qa, qb))


# ---- the decks through both packages ---------------------------------------

def _capture_initial(monkeypatch, module):
    """Record the (u, flags, T) a run mode hands to make_initial_state."""
    seen = {}
    inner = module.make_initial_state

    def spy(shape, **kw):
        seen.update(u=np.array(kw["u"]), flags=np.array(kw["flags"]),
                    T=None if kw.get("T") is None else np.array(kw["T"]))
        return inner(shape, **kw)

    monkeypatch.setattr(module, "make_initial_state", spy)
    return seen


def _run_both(monkeypatch, jax_deck: Path, port_deck: Path):
    import latticeurbanwind_tpu.run.standard as jax_standard
    import latticeurbanwind_tpu_torch.run.standard as port_standard
    from latticeurbanwind_tpu.run.modes import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    jax_init = _capture_initial(monkeypatch, jax_standard)
    port_init = _capture_initial(monkeypatch, port_standard)
    (ref,) = jax_run_deck(jax_deck, impl="pallas", quiet=True)
    (got,) = run_deck(port_deck, device="cpu", quiet=True)
    return got, ref, port_init, jax_init


def _vtks(result):
    return {p.name: p for p in result.files if p.suffix == ".vtk"}


def _compare_outputs(got, ref, port_init, jax_init, *, thermal=True):
    from latticeurbanwind_tpu.io import read_structured_points

    np.testing.assert_array_equal(port_init["flags"], jax_init["flags"])
    np.testing.assert_array_equal(port_init["u"], jax_init["u"])
    if thermal:
        np.testing.assert_array_equal(port_init["T"], jax_init["T"])
    np.testing.assert_array_equal(got.state.flags.numpy(),
                                  np.asarray(ref.state.flags))
    assert got.total_steps == ref.total_steps
    gv, rv = _vtks(got), _vtks(ref)
    assert sorted(gv) == sorted(rv)
    assert any("_avg-" in n for n in gv)
    assert any("_raw_T-" in n for n in gv) == thermal
    tol = {"u_avg": 2e-3, "rho_avg": 1e-4, "T_avg": 2e-3, "tke": 1e-4,
           "fluid": 0.0}
    for name in sorted(rv):
        _, fw = read_structured_points(rv[name])
        _, fg = read_structured_points(gv[name])
        assert sorted(fg) == sorted(fw), name
        if "_avg-" in name:
            assert ("T_avg" in fw) == thermal
            fluid = fw["fluid"] > 0.5
            for key in fw:
                a, b = fg[key][..., fluid], fw[key][..., fluid]
                assert np.isfinite(a).all(), (name, key)
                if key in ("TI", "TLS"):
                    np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5,
                                               err_msg=f"{name}:{key}")
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=tol[key],
                                               err_msg=f"{name}:{key}")
        else:
            atol = 1e-4 if "_raw_rho-" in name else 2e-3
            np.testing.assert_allclose(fg["data"], fw["data"], rtol=0,
                                       atol=atol, err_msg=name)


@pytest.mark.parametrize("variant", ["nearest", "high_order", "patch"])
def test_synthetic_standard_decks_match_jax(tmp_path, monkeypatch, variant):
    """The three synthetic decks of tests/test_standard_mode.py, one per BC
    route, T on: flags, initial u and T equal; `_avg` and raw VTKs at the
    module's tolerances."""
    from latticeurbanwind_tpu.io import read_structured_points
    from tests.test_standard_mode import _write_synthetic_case

    for side in ("jax", "port"):
        case = tmp_path / side
        _write_synthetic_case(case, with_patch=(variant == "patch"),
                              with_T=True, high_order=(variant == "high_order"))
        with open(case / "conf.luw", "a") as fh:
            fh.write("lbm_storage = f32\n")
    got, ref, port_init, jax_init = _run_both(
        monkeypatch, tmp_path / "jax" / "conf.luw", tmp_path / "port" / "conf.luw")
    assert got.total_steps == 30
    _compare_outputs(got, ref, port_init, jax_init)
    # the JAX test's own physical checks, on the port's output
    avg = next(p for n, p in _vtks(got).items() if "_avg-" in n)
    _, fields = read_structured_points(avg)
    fluid = fields["fluid"] > 0.5
    assert fields["u_avg"][0][fluid].mean() > 0.5
    assert 285.0 < fields["T_avg"][fluid].mean() < 303.0


def _prepared_copy(dst: Path, **changes) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(PREPARED, dst)
    deck = load_deck(dst / "conf.luw")
    deck.set_float("cell_size", 32.0)
    deck.set_int("run_nstep", 20)
    deck.set_int("purge_avg", 8)
    deck.set_text("lbm_storage", "f32")
    for key, value in changes.items():
        deck.set_raw(key, value)
    deck.save()
    return dst / "conf.luw"


def test_prepared_nwp_deck_matches_jax(tmp_path, monkeypatch, capsys):
    """The prepared NWP example at 32 m (95x83x8 cells), 20 steps, as it
    ships otherwise: patch-2d route, T on, VK inlet on, Coriolis, nudging
    and the top sponge, one probe column.  VTKs as above; the probe CSV's
    header, heights and times equal and its u:v:w cells within 2e-3 m/s."""
    got, ref, port_init, jax_init = _run_both(
        monkeypatch, _prepared_copy(tmp_path / "jax"),
        _prepared_copy(tmp_path / "port"))
    assert got.total_steps == 20
    assert got.state.gi is not None and port_init["T"] is not None
    assert (port_init["flags"] & 0x04).any()          # TYPE_T cells
    _compare_outputs(got, ref, port_init, jax_init)

    def probe_csv(result):
        (path,) = [p for p in result.files if p.suffix == ".csv"]
        rows = [line.split(",") for line in path.read_text().splitlines()]
        cells = np.array([[[float(v) for v in c.split(":")] for c in r[1:]]
                          for r in rows[1:]])
        return path.name, rows[0], [r[0] for r in rows[1:]], cells

    name_g, head_g, heights_g, cells_g = probe_csv(got)
    name_r, head_r, heights_r, cells_r = probe_csv(ref)
    assert name_g == name_r == "121.324_31.12.csv"
    assert head_g == head_r and len(head_g) == 1 + 4      # 4 samples
    assert heights_g == heights_r and len(heights_g) > 2
    np.testing.assert_allclose(cells_g, cells_r, rtol=0, atol=2e-3)
    assert np.abs(cells_g).max() > 0.5


def test_prepared_nwp_deck_without_temperature(tmp_path, monkeypatch):
    """`buoyancy = false`: the same deck without the temperature sub-lattice
    (no `_raw_T`, no `T_avg`), still equal to the JAX package's run."""
    got, ref, port_init, jax_init = _run_both(
        monkeypatch, _prepared_copy(tmp_path / "jax", buoyancy="false"),
        _prepared_copy(tmp_path / "port", buoyancy="false"))
    assert got.state.gi is None and port_init["T"] is None
    _compare_outputs(got, ref, port_init, jax_init, thermal=False)


# ---- (g) what the entry point takes and refuses -----------------------------

def test_standard_mode_needs_the_card_unless_asked_for_the_cpu(tmp_path,
                                                               monkeypatch):
    from latticeurbanwind_tpu_torch.cli.run import main
    from latticeurbanwind_tpu_torch.run.standard import run_standard_mode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deck = _prepared_copy(tmp_path / "nocard", cell_size="64.0", run_nstep="4",
                          purge_avg="0")
    for run in (lambda: run_standard_mode(deck, quiet=True),
                lambda: run_standard_mode(deck, device="cuda", quiet=True),
                lambda: main([str(deck), "--quiet"])):
        with pytest.raises(RuntimeError, match="no CUDA device.*device=.cpu"):
            run()
    assert not (tmp_path / "nocard" / "RESULTS").exists()
    (r,) = run_standard_mode(deck, device="cpu", quiet=True)
    assert r.total_steps == 4
    assert {"setup_bc_seconds", "setup_state_seconds",
            "voxelize_seconds"} <= set(r.timing)


def test_standard_mode_refuses_a_device_mesh(tmp_path):
    """A device mesh is no longer refused (the name dates from when it
    was): a split runs the `.luw` case sharded (T on, probe, averages) and
    writes the unsplit run's raw VTKs, probe CSV and averages at fluid
    cells: one that divides the 48x42x4 grid, [2, 1, 2], and one that does
    not, [1, 1, 3] (slabs of 2, 1 and 1 planes)."""
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    small = dict(cell_size="64.0", run_nstep="8", purge_avg="4")
    (whole,) = run_deck(_prepared_copy(tmp_path / "whole", **small),
                        device="cpu", quiet=True)
    want = {f.name: f for f in whole.files}
    for n_gpu in ("[2, 1, 2]", "[1, 1, 3]"):
        (split,) = run_deck(_prepared_copy(tmp_path / n_gpu[1::3], n_gpu=n_gpu,
                                           **small), device="cpu", quiet=True)
        assert split.avg.count == whole.avg.count > 0
        got = {f.name: f for f in split.files}
        assert sorted(got) == sorted(want)
        for name in sorted(want):
            if name.endswith(".csv"):
                assert got[name].read_text() == want[name].read_text()
                continue
            _, fg = read_structured_points(got[name])
            _, fw = read_structured_points(want[name])
            for key in fw:      # both runs sample update_fields (T on)
                np.testing.assert_array_equal(fg[key], fw[key],
                                              err_msg=n_gpu + name + key)


def test_thermal_run_samples_fields_not_the_fused_pass(tmp_path, monkeypatch):
    """A thermal run's averaging samples take update_fields + welford_update
    (mean_T included); the fused averaging pass refuses thermal as the JAX
    package's does, and the T-off run without probes takes it."""
    import latticeurbanwind_tpu_torch.run.driver as driver
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig
    from latticeurbanwind_tpu_torch.ops.avg_kernel import check_config
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    calls = []
    inner = driver.avg_update
    monkeypatch.setattr(driver, "avg_update",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    small = dict(cell_size="64.0", run_nstep="12", purge_avg="6")
    (r,) = run_deck(_prepared_copy(tmp_path / "t", **small), device="cpu",
                    quiet=True)
    assert not calls and r.avg.count == 3 and r.avg.mean_T is not None
    assert float(r.avg.mean_T.abs().max()) > 0.5
    (r,) = run_deck(_prepared_copy(tmp_path / "n", buoyancy="false",
                                   probes="[]", **small),
                    device="cpu", quiet=True)
    assert len(calls) == 3 and r.avg.count == 3 and r.avg.mean_T is None
    with pytest.raises(NotImplementedError, match="non-thermal"):
        check_config(StepConfig(omega=1.5, thermal=True))
