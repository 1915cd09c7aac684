"""Every cell's path at a tiny size on the CPU, through the harness's own
window, check and readers: the port's plain versions against the
reference, which agree exactly there."""

import pytest

from luwbench import harness, spec
from tiny import run_tiny, tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, tmp_path):
    cell = tiny_cell(name)
    run, result, line = run_tiny(cell, tmp_path, seconds=2.0)
    assert result.correct, line["compared"]
    assert result.attempted == len(line["compared"]) >= 4
    assert all(c["value"] == 0.0 for c in line["compared"].values())
    assert list(line)[-1] == "compared"
    assert "setup_s" in line["metrics"]
    e2e = "case_s" if cell.workload["window"] != "steps" else "mlups"
    assert line["metrics"][e2e]["value"] > 0
    if cell.workload["window"] == "steps":
        assert run.steps > 0 and run.cases_done == 0
    else:
        assert run.cases_done >= 1
        for name_ in ("case_setup_s.sweep", "solve_s.sweep", "output_s.sweep"):
            assert spec.reader(name_).read(run) >= 0
    assert harness.forbidden_modules() == []


def test_seed_sets_the_inputs_not_the_sizes():
    cell = tiny_cell("datagen-2m.sweep")
    a, b = harness.deck_keys(cell, 3), harness.deck_keys(cell, 2 ** 31 + 3)
    assert a["angle"] != harness.deck_keys(cell, 4)["angle"]
    assert sorted(a["angle"]) == sorted(b["angle"]) == sorted(cell.config["deck"]["angle"])
    steady = tiny_cell("profile-1p5m.steady")
    assert harness.deck_keys(steady, 2 ** 31 + 99)["vk_inlet_seed"] == 2 ** 31 + 99


def test_instrumented_swaps_run_case_in_every_run_mode():
    """Every module of the port's `run` package that binds `run_case` by
    name has it swapped while a run is instrumented, and put back after;
    `run/batch.py` alone keeps the program's (its threads would share one
    probe)."""
    import importlib
    import pkgutil

    from latticeurbanwind_tpu_torch import run as run_pkg
    from latticeurbanwind_tpu_torch.run import driver

    real = driver.run_case
    binders = {}
    for info in pkgutil.iter_modules(run_pkg.__path__):
        mod = importlib.import_module(f"{run_pkg.__name__}.{info.name}")
        if mod is not driver and getattr(mod, "run_case", None) is real:
            binders[info.name] = mod
    assert {"batch", "modes", "standard"} <= set(binders)
    with harness.instrumented(harness.Probe()):
        swapped = {n for n, m in binders.items() if m.run_case is not real}
        assert driver.run_case is real
    assert swapped == set(binders) - {"batch"}
    assert all(m.run_case is real for m in binders.values())
