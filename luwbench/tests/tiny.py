"""A cell at a size the CPU tests can hold: the configuration's own `tiny`
sizes (deck keys set, check stretch keys capped), so a new configuration
brings its own."""

import shutil
import time
from pathlib import Path

from luwbench import check, harness, spec


def shrink(cell: spec.Cell) -> spec.Cell:
    tiny = cell.config["tiny"]
    cell.config["deck"].update(tiny.get("deck", {}))
    chk = cell.workload["check"]
    for key, most in tiny.get("check", {}).items():
        chk[key] = min(chk[key], most)
    return cell


def data_copy(tmp_path: Path) -> Path:
    """A copy of the benchmark's data files (`luwbench/` without its code),
    to which a test adds a cell by files and entries alone."""
    root = tmp_path / "luwbench"
    for sub in ("configs", "workloads", "metrics", "cases"):
        shutil.copytree(spec.ROOT / sub, root / sub)
    return root


def tiny_cell(name: str, bench=None, root: Path = spec.ROOT) -> spec.Cell:
    return shrink(spec.cell(name, bench or spec.benchmark(), root))


def run_tiny(cell: spec.Cell, tmp_path: Path, *, seed: int = 2147483801,
             seconds: float = 1.0, check_fn=None):
    """(Run, Result, result line) of one run on the CPU."""
    t0 = time.perf_counter()
    run, result = harness.execute(cell, seed, seconds, False, t_process=t0,
                                  work_dir=tmp_path, device="cpu",
                                  check_fn=check_fn or check.check)
    bench = spec.benchmark()
    line = harness.result_line(run, result, cell.end_to_end,
                               spec.metric_units(bench))
    return run, result, line
