"""A cell added by files and entries alone: a copy of the benchmark's data
with one more traffic file and its BENCHMARK.json entries runs through the
unchanged harness.  The example is a sweep of the rose at one inflow, its
averaging every step."""

import json

from luwbench import spec
from tiny import data_copy, run_tiny, shrink

ONE_INFLOW = {
    "config": "datagen-2m",
    "window": "cases",
    "why": "the wind rose at 8 m/s alone, averaging every step",
    "deck": {"case_parallel": False, "inflow": [8.0], "purge_avg_stride": 1},
    "seed": {"rotate": {"angle": 1}},
    "warmup": {"steps": 24, "samples": 2},
    "check": {"rounds": 8, "steps": 2, "samples": True},
    "trace": {"case": 2},
    "limits": {"ddf_rms": 0.07, "ddf_max": 0.008, "avg_max": 0.001,
               "setup_max": 0.0004, "out_max": 0.001, "samples_gap": 0,
               "sample_max": 0.001},
}


def test_cell_added_from_files(tmp_path):
    root = data_copy(tmp_path)
    (root / "workloads" / "datagen-2m.inflow8.json").write_text(
        json.dumps(ONE_INFLOW))
    bench = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "datagen-2m.inflow8", "config": "datagen-2m",
                               "traffic": "inflow8", "chips": 1,
                               "why": "the wind rose at 8 m/s alone"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "datagen-2m.sweep" in m.get("workloads", ()):
            m["workloads"].append("datagen-2m.inflow8")
    cell = shrink(spec.cell("datagen-2m.inflow8", bench, root))
    assert "case_s" in cell.end_to_end and "solve_s.sweep" in cell.per_layer
    run, result, line = run_tiny(cell, tmp_path / "work", seconds=1.0)
    assert result.correct, line["compared"]
    assert run.cases_done >= 1
    assert {c.prefix.split("_")[1] for c in run.cases} == {"8"}
    assert run.cases[-1].samples == 40          # purge_avg 40 at stride 1
