"""PyTorch port, case-parallel batches (`run/batch.py`, dispatched by
`run/modes.py`), mirroring `tests/test_case_parallel.py`.

The `.luwdg` example at 30 m cells (18x18x5, f32 storage), one inflow and
three angles, 30 steps with 4 averaging samples:

  * the port's case-parallel run over three CPU devices (one thread and one
    case each) writes the serial run's files byte for byte;
  * its `_avg` VTKs are within the JAX package's rtol 2e-4 (atol 2e-5) of
    the JAX package's case-parallel run (pallas tier, interpret mode) at the
    cells that are not solid (both packages' fused averaging pass keeps the
    accumulators at solid cells, which the JAX batch loop samples);
  * `case_parallel_unsupported` gives the JAX package's reason on each
    ineligible batch, and an ineligible deck runs serially with its line.
"""

import functools
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "example_DatasetGen"
ANGLES = (0.0, 45.0, 90.0)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _prep(case_dir: Path, parallel: bool, **extra):
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLE, case_dir)
    deck = load_deck(case_dir / "conf.luwdg")
    deck.set_text("mesh_control", "cell_size", quoted=True)
    deck.set_float("cell_size", 30.0)
    deck.set_text("lbm_storage", "f32")
    deck.set_int("run_nstep", 30)
    deck.set_int("purge_avg", 12)
    deck.set_int("purge_avg_stride", 3)
    deck.set_list("inflow", [6.0])
    deck.set_list("angle", list(ANGLES))
    deck.set_bool("case_parallel", parallel)
    for key, value in extra.items():
        deck.set_int(key, value)
    deck.save()
    return case_dir / "conf.luwdg"


def _vtks(result):
    return {f.name: f for f in result.files if f.suffix == ".vtk"}


def test_datagen_case_parallel_matches_serial_and_jax(tmp_path, capsys,
                                                      monkeypatch):
    import latticeurbanwind_tpu_torch.run.batch as batch
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    serial = run_deck(_prep(tmp_path / "serial", False), device="cpu",
                      quiet=True)
    # three devices for the batch: three CPU "cards", one thread each
    threads = set()
    real_run_on = batch._run_on

    def run_on(case, dev):
        import threading

        threads.add(threading.get_ident())
        return real_run_on(case, dev)

    monkeypatch.setattr(batch, "run_cases_case_parallel", functools.partial(
        batch.run_cases_case_parallel, devices=[torch.device("cpu")] * 3))
    monkeypatch.setattr(batch, "_run_on", run_on)
    capsys.readouterr()
    par = run_deck(_prep(tmp_path / "par", True), device="cpu", quiet=False)
    out = capsys.readouterr().out
    assert ("| Case-parallel   | 3 cases over 3 device(s), tier=plain, 30 steps "
            "(avg window 12 @ stride 3)") in out
    assert out.count("| Case-parallel   | batch of 3: ") == 1
    assert len(threads) == 3
    assert len(serial) == len(par) == len(ANGLES)
    assert all(r.timing["case_parallel_batch"] == 3.0 for r in par)
    # only the last case keeps its final state, as in a serial batch
    assert [r.state is None for r in par] == [True, True, False]

    for rs, rp in zip(serial, par):
        fs, fp = _vtks(rs), _vtks(rp)
        assert sorted(fs) == sorted(fp)
        for name in fs:
            assert fp[name].read_bytes() == fs[name].read_bytes(), name

    ref = jax_run_deck(_prep(tmp_path / "jax", True), impl="pallas", quiet=True)
    assert all("case_parallel_batch" in r.timing for r in ref)
    for rj, rp in zip(ref, par):
        fj, fp = _vtks(rj), _vtks(rp)
        assert sorted(fj) == sorted(fp)
        name = next(n for n in fj if "_avg-" in n)
        _, a_j = read_structured_points(fj[name])
        _, a_p = read_structured_points(fp[name])
        assert sorted(a_j) == sorted(a_p)
        fluid = a_j["fluid"] > 0.5
        np.testing.assert_array_equal(a_p["fluid"], a_j["fluid"])
        for key in ("u_avg", "rho_avg", "tke"):
            np.testing.assert_allclose(
                a_p[key][..., fluid], a_j[key][..., fluid], rtol=2e-4,
                atol=2e-5, err_msg=f"{name}:{key}")
    # distinct angles produce distinct flow fields
    _, a0 = read_structured_points(next(f for f in par[0].files if "_avg-" in f.name))
    _, a1 = read_structured_points(next(f for f in par[1].files if "_avg-" in f.name))
    assert np.abs(a0["u_avg"] - a1["u_avg"]).max() > 0.1


def test_ineligible_batch_runs_serially_with_the_reason(tmp_path, capsys):
    """unsteady_output within the run: the JAX package's reason, then the
    serial driver case by case (each with its raw u at the event)."""
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    capsys.readouterr()
    results = run_deck(_prep(tmp_path / "d", True, run_nstep=6,
                             unsteady_output=3, purge_avg=0),
                       device="cpu", quiet=False, max_cases=2)
    out = capsys.readouterr().out
    assert ("| Case-parallel   | falling back to serial: unsteady/frame/"
            "checkpoint events need the serial driver") in out
    assert len(results) == 2
    assert all("case_parallel_batch" not in r.timing for r in results)
    assert all(any("_raw_u-000000003" in f.name for f in r.files)
               for r in results)


def _case(pkg, **kw):
    """One case of the JAX package (`pkg == "jax"`, numpy arrays) or of the
    port (tensors) on a (4, 8, 8) grid, `kw` over the defaults."""
    import dataclasses

    if pkg == "jax":
        from latticeurbanwind_tpu.lbm.state import (
            DynParams, Forcing, LBMState, StepConfig,
        )
        from latticeurbanwind_tpu.run.driver import RunSettings, SolverCase

        def put(a):
            return a
    else:
        from latticeurbanwind_tpu_torch.lbm.state import (
            DynParams, Forcing, LBMState, StepConfig,
        )
        from latticeurbanwind_tpu_torch.run.driver import RunSettings, SolverCase

        put = torch.from_numpy

    shape = kw.pop("shape", (4, 8, 8))
    st = LBMState(fi=put(np.zeros((19, *shape), np.float32)),
                  rho=put(np.zeros(shape, np.float32)),
                  u=put(np.zeros((3, *shape), np.float32)),
                  flags=put(np.zeros(shape, np.uint8)), gi=None, T=None)
    config = dataclasses.replace(StepConfig(omega=1.0), **kw.pop("config", {}))
    forcing = (Forcing(sponge_sigma_z=put(np.zeros(shape[0], np.float32)))
               if kw.pop("sponge", False) else Forcing())
    dyn = None
    if "force" in kw:
        dyn = DynParams(force=put(np.asarray(kw.pop("force"), np.float32)),
                        omega_coriolis=put(np.zeros(3, np.float32)))
    base = dict(config=config, forcing=forcing, state=st, dyn=dyn, units=None,
                cell_m=1.0, parent=Path("."), datetime="0",
                settings=RunSettings(run_nstep=10, **kw.pop("settings", {})))
    base.update(kw)
    return SolverCase(**base)


@pytest.mark.parametrize("first, second", [
    (dict(), None),                                         # one case
    (dict(), dict()),                                       # eligible
    (dict(config=dict(thermal=True)), dict(config=dict(thermal=True))),
    (dict(probes=[object()]), dict()),
    (dict(pre_step=object()), dict()),
    (dict(settings=dict(unsteady_output=5)), dict()),
    (dict(settings=dict(frame_output=5)), dict()),
    (dict(settings=dict(checkpoint_interval=5)), dict()),
    (dict(settings=dict(checkpoint_interval=50)), dict()),  # beyond the run
    (dict(), dict(config=dict(storage="bf16"))),
    (dict(), dict(shape=(4, 8, 16))),
    (dict(), dict(sponge=True)),
    (dict(ngpu=(2, 1, 1)), dict()),
    (dict(force=[0.0, 0.0, 0.0]), dict(force=[0.0, 0.0, 1e-3])),
    (dict(force=[0.0, 0.0, 1e-3]), dict(force=[0.0, 0.0, 1e-3])),
])
def test_case_parallel_unsupported_reasons_match_jax(first, second):
    import copy

    from latticeurbanwind_tpu.run.batch import (
        case_parallel_unsupported as jax_unsupported,
    )
    from latticeurbanwind_tpu_torch.run.batch import case_parallel_unsupported

    def batch(pkg):
        specs = [first] if second is None else [first, second]
        return [_case(pkg, **copy.deepcopy(s)) for s in specs]

    want = jax_unsupported(batch("jax"))
    assert case_parallel_unsupported(batch("port")) == want
    if first == second == {}:
        assert want is None
