"""PyTorch port: the step held to published values, as the JAX package's
reference tier is (tests/test_cavity_validation.py,
tests/test_strouhal_validation.py, tests/test_lbm_physics.py).

Each check of `lbm/physics_checks.py` has the JAX test's setup, published
value and tolerance, and runs through the port's step loop on the CPU: the
plain versions of the kernels, which chip_smoke.py's phase 5 runs on the
card.  The vortex street (12,000 steps at 75,000 cells, ~10 minutes on one
CPU thread) is marked slow; the cavity runs to steady state in ~10,500
steps (~70 s).
"""

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

from latticeurbanwind_tpu_torch.lbm.physics_checks import CHECKS

FAST = ["cavity", "taylor_green", "poiseuille", "thermal_diffusion",
        "coriolis", "boussinesq", "schumann_drag", "wall_sides"]


@pytest.mark.parametrize("name", [
    *FAST, pytest.param("strouhal", marks=pytest.mark.slow)])
def test_port_step_matches_published_value(name):
    check = CHECKS[name]("cpu")
    assert check.ok, str(check)


def test_every_check_has_a_test():
    assert sorted(CHECKS) == sorted(FAST + ["strouhal"])


@pytest.mark.parametrize("name", ["taylor_green", "thermal_diffusion", "schumann_drag"])
def test_check_keeps_its_simulations(name):
    """A check hands back its simulations, each with the host arrays it
    started from and copies of its initial DDFs, and their steps add up
    to the check's: what chip_smoke.py's phase 5 restarts K-SC from."""
    import torch

    from latticeurbanwind_tpu_torch.lbm.state import make_initial_state

    check = CHECKS[name]("cpu")
    assert check.sims and sum(s.steps for s in check.sims) == check.steps > 0
    for sim in check.sims:
        st = make_initial_state(sim.shape, config=sim.config, **sim.init)
        fi, gi = sim.initial
        assert torch.equal(fi, st.fi)
        assert (gi is None) == (st.gi is None) == (not sim.config.thermal)
        assert gi is None or torch.equal(gi, st.gi)
        moved = not torch.equal(fi, sim.state.fi) or (
            gi is not None and not torch.equal(gi, sim.state.gi))
        assert moved                 # the copies are not the state stepped on
