"""On an NVIDIA card: the command itself, briefly, for each one-card cell,
and the control at the cells' own size (three seeds each), which must fail
a limit that the program's readings pass.  These skip without a card."""

import json
import subprocess
import sys

import pytest

from luwbench import check, spec

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("name", ONE_CARD)
def test_command_on_the_card(name, card):
    out = subprocess.run(
        [sys.executable, "luwbench/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "12", "--trace", "0"],
        cwd=spec.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["compared"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "compared"


@pytest.mark.card
@pytest.mark.parametrize("name", ONE_CARD)
def test_control_at_the_cells_size(name, card):
    out = subprocess.run(
        [sys.executable, "luwbench/control.py", "--workload", name, "--seeds",
         "2147484011,2600000021,3300000031", "--seconds", "6"],
        cwd=spec.REPO, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    limits = spec.workload(name)["limits"]
    for row in (json.loads(r) for r in out.stdout.strip().splitlines()):
        assert check.judge(row["program"], limits).correct, row
        assert not check.judge(row["control"], limits).correct, row
