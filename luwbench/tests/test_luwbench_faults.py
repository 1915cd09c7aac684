"""The check sees a broken timed path: each fault is planted in the
program underneath a run at a tiny size on the CPU (the harness's look for
a card skipped), and `correct` comes out false.  No cell splits a domain
over cards, so there is no exchange to leave out.  The control, the
reference a precision below the configuration's, fails the cells' limits
too."""

import pytest
import torch

from luwbench import check, harness
from tiny import run_tiny, tiny_cell


def _step_fault(kind):
    from latticeurbanwind_tpu_torch.lbm import stepper

    real = stepper.stream_collide

    def broken(fi, flags, dyn, config, forcing, fbc=None, *, out=None, **kw):
        if kind == "unchanged":
            out.copy_(fi)
            return out
        res = real(fi, flags, dyn, config, forcing, fbc, out=out, **kw)
        if kind == "half":
            z = fi.shape[1] // 2
            out[:, z:].copy_(fi[:, z:])
        elif kind == "altered":
            z, y, x = (s // 2 for s in fi.shape[1:])
            out[5, z, y, x] = (out[5, z, y, x].float() + 0.1).to(out.dtype)
        return res

    return stepper, "stream_collide", broken


def _avg_fault():
    from latticeurbanwind_tpu_torch.ops import avg_kernel

    real = avg_kernel.avg_update

    def half(fi, flags, dyn, inv_n, avg, config):
        if avg.count % 2:                  # every second sample left out
            return avg._replace(count=avg.count + 1)
        return real(fi, flags, dyn, inv_n, avg, config)

    return avg_kernel, "avg_update", half


def _stride_fault():
    """`run_case` averaging every fourth step where the deck asks for every
    second (its own count and weights consistent with that)."""
    from dataclasses import replace

    from latticeurbanwind_tpu_torch.run import driver

    real = driver.run_case

    def sparse(case, **kw):
        s = case.settings
        case.settings = replace(s, purge_avg_stride=2 * s.purge_avg_stride)
        return real(case, **kw)

    return driver, "run_case", sparse


def _weight_fault():
    """`run_case`'s samples weighted twice what Welford's step asks."""
    from latticeurbanwind_tpu_torch.run import driver

    real = driver.avg_update

    def heavy(fi, flags, dyn, inv_n, avg, config):
        return real(fi, flags, dyn, 2.0 * inv_n, avg, config)

    return driver, "avg_update", heavy


def _output_fault():
    from latticeurbanwind_tpu_torch.run import driver

    real = driver.write_structured_points

    def altered(path, fields, **kw):
        if "u_avg" in fields:
            fields = dict(fields)
            u = fields["u_avg"].copy()
            u[0].flat[u[0].size // 2] += 0.05
            fields["u_avg"] = u
        return real(path, fields, **kw)

    return driver, "write_structured_points", altered


FAULTS = [
    ("profile-1p5m.steady", lambda: _step_fault("unchanged")),
    ("profile-1p5m.steady", lambda: _step_fault("half")),
    ("profile-1p5m.steady", lambda: _step_fault("altered")),
    ("datagen-2m.sweep", lambda: _step_fault("unchanged")),
    ("profile-1p5m.avg", _avg_fault),
    ("datagen-2m.sweep", _output_fault),
    ("profile-1p5m.avg", _stride_fault),
    ("datagen-2m.sweep", _stride_fault),
    ("profile-1p5m.avg", _weight_fault),
    ("datagen-2m.sweep", _weight_fault),
]
IDS = ["steady-unchanged", "steady-half", "steady-altered", "sweep-unchanged",
       "avg-half-samples", "sweep-output-altered", "avg-every-4th-step",
       "sweep-every-4th-step", "avg-weight-doubled", "sweep-weight-doubled"]


@pytest.mark.parametrize("name,fault", FAULTS, ids=IDS)
def test_fault_makes_run_incorrect(name, fault, tmp_path, monkeypatch):
    mod, attr, broken = fault()
    monkeypatch.setattr(mod, attr, broken)
    if attr == "avg_update":
        from latticeurbanwind_tpu_torch.run import driver

        monkeypatch.setattr(driver, "avg_update", broken)
    _, result, line = run_tiny(tiny_cell(name), tmp_path, seconds=1.5)
    assert not result.correct, line["compared"]
    assert result.failed >= 1


def test_window_that_misses_the_runner_ends(tmp_path, monkeypatch):
    """A window of steps whose runner the benchmark does not reach (here:
    its wrapper taken away) ends within seconds, not after a million
    steps."""
    monkeypatch.setattr(harness, "wrap_runner", lambda run, probe: run)
    monkeypatch.setattr(harness.Watchdog, "FIRST_S", 0.5)
    with pytest.raises(RuntimeError, match="never reached the program's runner"):
        run_tiny(tiny_cell("profile-1p5m.steady"), tmp_path, seconds=60.0)


@pytest.mark.parametrize("name", ["profile-1p5m.avg", "datagen-2m.sweep"])
def test_control_fails_the_limits(name, tmp_path):
    """The control in the program's place reads above every limit."""
    from luwbench.control import readings

    cell = tiny_cell(name)
    got = {}

    def fn(cell_, run, stash, keys, work_dir):
        got["program"], got["control"] = readings(
            cell_, run, stash, keys, work_dir, device=torch.device("cpu"))
        return check.Result(True, 0, 0, {})

    run_tiny(cell, tmp_path, seconds=1.0, check_fn=fn)
    limits = cell.workload["limits"]
    assert set(got["control"]) == set(limits) - {"samples_gap"}
    assert check.judge(got["program"], limits).correct
    for k, v in got["control"].items():
        assert v > limits[k], (k, v, limits[k])
