"""PyTorch port, the whole slice: the example profile deck end to end through
the port's `run_deck` against the JAX package's pure-DDF tier.

Both runs take a copy of examples/example_ProfileResearch_noDEM with the VK
inlet off, f32 storage, 40 steps, a raw u VTK every 20 steps and 5 averaging
samples (purge_avg 10, stride 2); both angles run.  The JAX side runs
`run_deck(impl="pallas")` with the kernels in interpret mode, which is how
its own tests run them on the CPU.  Its raw `u` is `update_fields` of the
streamed populations, the quantity the port reports too (the JAX reference
tier stores the step's u* instead, which differs by the nudge/sponge forces).

Tolerances: the two runs differ only by fp32 evaluation order, ~1e-7
relative per step, grown by 40 LES steps to ~1e-6 of the lattice velocity;
in SI (u_factor ~41 m/s per lattice unit) that is ~3e-5 m/s on flows of
~4 m/s, measured ~1.3e-5.  u and u_avg are held to 1e-4 m/s, rho fields to
1e-5 kg/m3, tke to 1e-5 m2/s2.  TI and TLS divide by |u_avg| and |S|, which
are small in recirculation zones, so they are held relatively: 1e-3.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "example_ProfileResearch_noDEM"


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("LUW_PALLAS_INTERPRET", "1")


def _deck_copy(dst: Path) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLE, dst)
    deck = load_deck(dst / "conf.luwpf")
    deck.set_text("turb_inflow_enable", "false")
    deck.set_text("lbm_storage", "f32")
    deck.set_int("run_nstep", 40)
    deck.set_int("unsteady_output", 20)
    deck.set_int("purge_avg", 10)
    deck.set_int("purge_avg_stride", 2)
    deck.save()
    return dst / "conf.luwpf"


def _vtks(results):
    return {f.name: f for r in results for f in r.files if f.suffix == ".vtk"}


def test_profile_deck_matches_jax_pure_ddf_tier(tmp_path):
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    port = run_deck(_deck_copy(tmp_path / "port"), device="cpu", quiet=True)
    ref = jax_run_deck(_deck_copy(tmp_path / "jax"), impl="pallas", quiet=True)

    assert [r.total_steps for r in port] == [40, 40]
    got, want = _vtks(port), _vtks(ref)
    assert sorted(got) == sorted(want)
    assert len(got) == 8          # per angle: u@20, u@40, rho@40, avg@40

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


def test_port_refuses_what_it_does_not_run(tmp_path):
    """The wall models (`ground_z0`, K4), dataset-generation decks
    (`.luwdg`), standard decks (`.luw`, module item 8) and thermal
    configurations (K7) run; so does a device mesh (`n_gpu`, module item
    11), whether the split divides the grid or not (uneven shards)."""
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig
    from latticeurbanwind_tpu_torch.lbm.stepper import make_runner
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    deck_path = _deck_copy(tmp_path / "wall")
    deck = load_deck(deck_path)
    deck.set_float("ground_z0", 0.1)
    deck.set_int("run_nstep", 4)
    deck.set_int("unsteady_output", 0)
    deck.set_int("purge_avg", 0)
    deck.save()
    (r,) = run_deck(deck_path, device="cpu", quiet=True, max_cases=1)
    assert r.total_steps == 4

    dg = tmp_path / "dg"
    shutil.copytree(EXAMPLE.parent / "example_DatasetGen", dg)
    deck = load_deck(dg / "conf.luwdg")
    deck.set_int("run_nstep", 4)
    deck.set_int("purge_avg", 0)
    deck.save()
    (r,) = run_deck(dg / "conf.luwdg", device="cpu", quiet=True, max_cases=1)
    assert r.total_steps == 4 and r.files[0].name.startswith("DG_4_0_")

    nwp = tmp_path / "nwp"
    shutil.copytree(EXAMPLE.parent / "example_NWP-LBM_prepared", nwp)
    deck = load_deck(nwp / "conf.luw")
    deck.set_float("cell_size", 64.0)
    deck.set_int("run_nstep", 4)
    deck.set_int("purge_avg", 0)
    deck.save()
    (r,) = run_deck(nwp / "conf.luw", device="cpu", quiet=True)
    assert r.total_steps == 4 and r.state.gi is not None
    assert any("_raw_T-" in f.name for f in r.files)
    run, impl = make_runner(StepConfig(omega=1.5, thermal=True),
                            shape=(4, 8, 8), device="cpu")
    assert impl == "plain"

    deck.set_raw("n_gpu", "[2, 1, 1]")
    deck.save()
    (r,) = run_deck(nwp / "conf.luw", device="cpu", quiet=True)
    assert r.total_steps == 4 and r.state.gi is not None
    deck.set_raw("n_gpu", "[1, 1, 3]")
    deck.save()
    (r,) = run_deck(nwp / "conf.luw", device="cpu", quiet=True)
    assert r.total_steps == 4 and r.state.gi is not None


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path,
                                                             monkeypatch):
    """Without a CUDA device, run_deck and the CLI without --device raise and
    point at the CPU run; nothing falls back to the CPU by itself."""
    import torch

    from latticeurbanwind_tpu_torch.cli.run import main
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deck_path = _deck_copy(tmp_path / "nocard")
    for run in (lambda: run_deck(deck_path, quiet=True),
                lambda: run_deck(deck_path, device="cuda", quiet=True),
                lambda: main([str(deck_path), "--quiet"])):
        with pytest.raises(RuntimeError, match="no CUDA device.*device=.cpu"):
            run()
    assert not (tmp_path / "nocard" / "RESULTS").exists()


def test_cli_runs_a_deck_on_the_cpu(tmp_path, capsys):
    from latticeurbanwind_tpu_torch.cli.run import main

    deck_path = _deck_copy(tmp_path / "cli")
    assert main([str(deck_path), "--device", "cpu", "--max-cases", "1",
                 "--quiet"]) == 0
    assert "1 case(s) complete" in capsys.readouterr().out
    vtks = sorted(p.name for p in (tmp_path / "cli" / "RESULTS" / "vtk").glob("*.vtk"))
    assert vtks == ["ANG_0_20260101120000_avg-000000040.vtk",
                    "ANG_0_20260101120000_raw_rho-000000040.vtk",
                    "ANG_0_20260101120000_raw_u-000000020.vtk",
                    "ANG_0_20260101120000_raw_u-000000040.vtk"]


@pytest.mark.parametrize("walls", [
    {}, {"ground_z0": 0.055}, {"ground_z0": 0.055, "building_z0": 0.01},
    {"ground_z0": 0.055, "building_z0": -1.0}, {"ground_z0": 2.0},
    {"building_z0": 0.01},
])
def test_wall_model_from_deck_matches_jax(tmp_path, walls):
    """`ground_z0` / `building_z0` give the JAX package's StepConfig (wall_cd
    from kappa / ln(z1/z0) with z1 half a cell, the ratio clamped at e;
    `building_z0 = -1` free-slip sides; no ground model, no side model)."""
    import dataclasses

    from latticeurbanwind_tpu.lbm import StepConfig as JaxStepConfig
    from latticeurbanwind_tpu.run.case import apply_wall_model as jax_apply
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.lbm.state import StepConfig
    from latticeurbanwind_tpu_torch.run.case import apply_wall_model

    deck_path = _deck_copy(tmp_path / "deck")
    deck = load_deck(deck_path)
    for key, value in walls.items():
        deck.set_float(key, value)
    deck.save()
    deck = load_deck(deck_path)
    for cell_m in (1.5, 8.0):
        got = apply_wall_model(StepConfig(omega=1.7, volume_force=False), deck,
                               cell_m)
        want = jax_apply(JaxStepConfig(omega=1.7, volume_force=False), deck,
                         cell_m)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.wall_model == ("ground_z0" in walls)
        assert got.wall_sides == (got.wall_model and "building_z0" in walls)
