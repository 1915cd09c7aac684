"""PyTorch port, the whole slice with the inlet on: the example profile deck
as it ships (the VK synthetic-turbulence inlet is on by default) through the
port's `run_deck` against the JAX package's `run_deck(impl="pallas")`.

Both runs take a copy of examples/example_ProfileResearch_noDEM with one
angle (0), f32 storage, 40 steps, a raw u VTK every 20 steps and 5 averaging
samples (purge_avg 10, stride 2), without a wall model, with the ground's
(`ground_z0 = 0.055`, the AIJ CaseE validation's value) and with the
vertical faces' as well (`building_z0 = 0.01`).  The JAX side runs its kernels in
interpret mode, as its own tests run them on the CPU.  Its inlet hook
refreshes the FaceBC targets before every step and its kernel applies the
inlet sites from them; the port does the same with `.ddf` and the plain
version of K-SC.

Tolerances are those of tests/test_torch_profile_mode.py: u and u_avg
1e-4 m/s, rho fields 1e-5 kg/m3, tke 1e-5 m2/s2, TI and TLS 1e-3 relative.
The inlet adds the mode sum's float32 cos/sin (XLA against torch, ~1 ulp
at arguments of a few hundred radians) scaled by sigma ~ 2e-3 lattice units
to the fp32 evaluation-order differences those tolerances already cover.
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


def _deck_copy(dst: Path, walls=None) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLE, dst)
    deck = load_deck(dst / "conf.luwpf")
    assert deck.get_raw("turb_inflow_enable") is None      # the inlet is on
    for key, value in (walls or {}).items():
        deck.set_float(key, value)
    deck.set_text("lbm_storage", "f32")
    deck.set_list("angle", [0.0])
    deck.set_int("run_nstep", 40)
    deck.set_int("unsteady_output", 20)
    deck.set_int("purge_avg", 10)
    deck.set_int("purge_avg_stride", 2)
    deck.save()
    return dst / "conf.luwpf"


@pytest.mark.parametrize("walls", [
    pytest.param({}, id="no-wall"),
    pytest.param({"ground_z0": 0.055}, id="ground"),
    pytest.param({"ground_z0": 0.055, "building_z0": 0.01}, id="ground+sides"),
])
def test_vk_deck_matches_jax_pallas_tier(tmp_path, capsys, monkeypatch, walls):
    from latticeurbanwind_tpu.io import read_structured_points
    from latticeurbanwind_tpu.run import run_deck as jax_run_deck
    from latticeurbanwind_tpu_torch.run import modes

    configs = []
    real_run_case = modes.run_case

    def run_case(case, **kw):
        configs.append(case.config)
        return real_run_case(case, **kw)

    monkeypatch.setattr(modes, "run_case", run_case)
    port = modes.run_deck(_deck_copy(tmp_path / "port", walls), device="cpu",
                          quiet=False)
    out = capsys.readouterr().out
    assert "| VK inlet        | active:" in out and "faces=[0, 1, 2, 3]" in out
    (cfg,) = configs
    assert cfg.wall_model == ("ground_z0" in walls)
    assert cfg.wall_sides == ("building_z0" in walls)
    ref = jax_run_deck(_deck_copy(tmp_path / "jax", walls), impl="pallas",
                       quiet=True)

    assert [r.total_steps for r in port] == [40]
    got = {f.name: f for r in port for f in r.files if f.suffix == ".vtk"}
    want = {f.name: f for r in ref for f in r.files if f.suffix == ".vtk"}
    assert sorted(got) == sorted(want) and len(got) == 4

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
