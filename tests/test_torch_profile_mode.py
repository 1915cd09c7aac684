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
    from latticeurbanwind_tpu_torch.deck import load_deck
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    deck_path = _deck_copy(tmp_path / "vk")
    deck = load_deck(deck_path)
    deck.set_text("turb_inflow_enable", "true")
    deck.save()
    with pytest.raises(NotImplementedError, match="module item 7"):
        run_deck(deck_path, device="cpu", quiet=True)
    for suffix in ("luw", "luwdg"):
        other = tmp_path / f"conf.{suffix}"
        other.write_text("casename = x\n")
        with pytest.raises(NotImplementedError, match="module item 8"):
            run_deck(other, device="cpu", quiet=True)


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
