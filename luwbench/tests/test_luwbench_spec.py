"""BENCHMARK.json and the data files it names: every configuration, cell
and metric loads by its name, and the file keeps the contract's shape."""

import json
import re

import pytest

from luwbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert (spec.REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["luwbench"]
    assert BENCH["command"][1] == "luwbench/run.py"


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    data = spec.config(c["name"])
    assert c["file"] == f"luwbench/configs/{c['name']}.json"
    assert data["name"] == c["name"] and data["source"] == c["source"]
    assert sorted(data["reduced"]) == sorted(c["reduced"])
    assert (spec.ROOT / "configs" / data["inputs"] / data["deck_file"]).exists()
    ref = spec.reference(data["reference"])
    assert all(callable(getattr(ref, f)) for f in
               ("tables", "follow", "average", "sample"))
    assert set(data["tiny"]) <= {"deck", "check"}
    for text in (c["why"], c["source"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    cell = spec.cell(w["name"], BENCH)
    assert cell.workload["config"] == w["config"]
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    assert cell.workload["window"] in ("steps", "cases")


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_loads_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    mod = spec.reader(m["name"])
    assert callable(mod.read)
    if "layer" in m:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        e2e = {e["name"] for e in BENCH["end_to_end"]}
        assert m["moves"] in e2e
    else:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_layers_spelled_alike():
    by = {}
    for m in BENCH["per_layer"]:
        by.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by.values())


def test_every_config_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    json.dumps(BENCH)


def test_reference_imports_nothing_of_the_program():
    """The reference and the yardstick load neither the port, the JAX
    package nor JAX (compared by whole top-level names)."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import luwbench.reference.setup, luwbench.reference.follow, "
            "luwbench.counts, luwbench.trace\n"
            "from luwbench import spec\n"
            "for c in spec.benchmark()['configs']:\n"
            "    spec.reference(spec.config(c['name'])['reference'])\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'latticeurbanwind_tpu', "
            "'latticeurbanwind_tpu_torch'})\n"
            "print(bad)" % str(spec.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
