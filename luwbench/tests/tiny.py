"""A cell at a size the CPU tests can hold: the same decks at coarse cells,
short runs and short check stretches."""

import time
from pathlib import Path

from luwbench import check, harness, spec

TINY_CELL_M = {"profile": 16.0, "datagen": 20.0}


def shrink(cell: spec.Cell) -> spec.Cell:
    deck = cell.config["deck"]
    if cell.config["deck_file"].endswith(".luwpf"):
        deck["cell_size"] = TINY_CELL_M["profile"]
        cell.workload["check"]["steps"] = min(cell.workload["check"]["steps"], 6)
    else:
        deck.update(cell_size=TINY_CELL_M["datagen"], run_nstep=120, purge_avg=40)
        cell.workload["check"]["rounds"] = 2
    return cell


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
