"""The benchmark's data: `BENCHMARK.json`, the configurations, the traffic
mixes and the metric readers, each found by its name.

  * `configs/<name>.json`: a configuration (the deck's keys as run, its
    source, what was changed from it, the reference that rebuilds its case,
    its sizes for the CPU tests) with its raw inputs in
    `configs/<inputs>/`;
  * `cases/<reference>.py`: the plain reference of one kind of deck, named
    by a configuration's `reference` key: `tables(prod, device)` (the case
    worked out again from the raw deck), `follow(tables, prod, rounds,
    steps, device, low)` -> (DDFs, thermal DDFs or None, face targets),
    `average(tables, samples, device, low)` and `sample(sample, tables,
    device, low)` (the window's last averaging sample's Welford step);
  * `workloads/<name>.json`: a cell's traffic mix, read by the one general
    runner in `harness.py` (which window it runs, the deck keys it sets,
    how the seed enters, the check stretch, the traced stretch, the limits
    of the numbers compared);
  * `metrics/<name>.py`: one reader per metric, with `LAYER`, `MOVES` and
    `read(run) -> float | None` (None: nothing to read in this run).

A later cell, configuration or metric is new files and entries here; no
code changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent          # luwbench/
REPO = ROOT.parent                              # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def workload(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "workloads" / f"{name}.json")


def _load(kind: str, name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"luwbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader module of metric `name` (`metrics/<name>.py`)."""
    return _load("metric", name, root / "metrics" / f"{name}.py")


def reference(name: str, root: Path = ROOT) -> ModuleType:
    """The reference module of a kind of deck (`cases/<name>.py`)."""
    return _load("case", name, root / "cases" / f"{name}.py")


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # workloads/<name>.json
    config: dict         # configs/<config>.json
    end_to_end: List[str]
    per_layer: List[str]
    root: Path = ROOT

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @cached_property
    def reference(self) -> ModuleType:
        """The plain reference of the configuration's kind of deck."""
        return reference(self.config["reference"], self.root)


def _reports(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_of_cell if "moves" in metric else True


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its data files (under `root`)
    and the names of the metrics it reports."""
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(entries)})")
    entry = entries[name]
    e2e = [m["name"] for m in bench["end_to_end"]
           if _reports(m, name, [])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if _reports(m, name, e2e)]
    return Cell(name=name, entry=entry, workload=workload(name, root),
                config=config(entry["config"], root), end_to_end=e2e,
                per_layer=per_layer, root=root)


def metric_units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
