"""PyTorch port, the dataset-generation entry point: the example `.luwdg`
deck through the port's `run_deck` against the JAX package's
`run_deck(impl="pallas")`.

Both runs take a copy of examples/example_DatasetGen with its first two
cases (inflow 4 m/s, angles 0 and 45), f32 storage, 40 steps and 5
averaging samples (purge_avg 10, stride 2), each case writing its raw u and
rho and its `_avg` VTK under the `DG_<u>_<a>_` prefix.  The JAX side runs its
kernels in interpret mode, as its own tests run them on the CPU, with
`case_parallel = false` so that it steps the cases one after another as the
port does.  Tolerances are those of tests/test_torch_vk_deck.py: u and u_avg
1e-4 m/s, rho fields 1e-5 kg/m3, tke 1e-5 m2/s2, TI and TLS 1e-3 relative.

With the deck's own `case_parallel = true` the port's batch runner runs the
same cases on its one device in turn (batches of one), and its files are the
serial run's bit for bit.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "example_DatasetGen"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _deck_copy(dst: Path, case_parallel: bool) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLE, dst)
    deck = load_deck(dst / "conf.luwdg")
    assert deck.get_bool("case_parallel", False)            # as it ships
    deck.set_text("case_parallel", "true" if case_parallel else "false")
    deck.set_text("lbm_storage", "f32")
    deck.set_int("run_nstep", 40)
    deck.set_int("purge_avg", 10)
    deck.set_int("purge_avg_stride", 2)
    deck.save()
    return dst / "conf.luwdg"


def _vtks(results):
    return {f.name: f for r in results for f in r.files if f.suffix == ".vtk"}


def test_datagen_deck_matches_jax_pallas_tier(tmp_path, capsys):
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    port = run_deck(_deck_copy(tmp_path / "port", False), device="cpu",
                    quiet=True, max_cases=2)
    ref = jax_run_deck(_deck_copy(tmp_path / "jax", False), impl="pallas",
                       quiet=True, max_cases=2)

    assert [r.total_steps for r in port] == [40, 40]
    got, want = _vtks(port), _vtks(ref)
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(
        f"DG_4_{a}_20260101120000_{kind}-000000040.vtk"
        for a in (0, 45) for kind in ("raw_u", "raw_rho", "avg"))

    atol = {"u_avg": 1e-4, "rho_avg": 1e-5, "tke": 1e-5, "fluid": 0.0}
    for name in sorted(want):
        _, fw = read_structured_points(want[name])
        _, fg = read_structured_points(got[name])
        assert sorted(fg) == sorted(fw), name
        if "_avg-" in name:
            fluid = fw["fluid"] > 0.5
            assert fluid.any()
            for key in fw:
                a, b = fg[key][..., fluid], fw[key][..., fluid]
                assert np.isfinite(a).all(), (name, key)
                if key in ("TI", "TLS"):
                    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6,
                                               err_msg=f"{name}:{key}")
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=atol[key],
                                               err_msg=f"{name}:{key}")
        else:
            tol = 1e-4 if "_raw_u-" in name else 1e-5
            np.testing.assert_allclose(fg["data"], fw["data"], rtol=0, atol=tol,
                                       err_msg=name)

    # case_parallel = true on one device: the batch runner's batches of one,
    # the same files bit for bit, and its lines
    capsys.readouterr()
    batch = run_deck(_deck_copy(tmp_path / "batch", True), device="cpu",
                     quiet=False, max_cases=2)
    out = capsys.readouterr().out
    assert ("| Case-parallel   | 2 cases over 1 device(s), tier=plain, 40 steps "
            "(avg window 10 @ stride 2)") in out
    assert out.count("| Case-parallel   | batch of 1: ") == 2
    assert [r.timing["case_parallel_batch"] for r in batch] == [1.0, 1.0]
    files = _vtks(batch)
    assert sorted(files) == sorted(got)
    for name, path in got.items():
        assert files[name].read_bytes() == path.read_bytes(), name
