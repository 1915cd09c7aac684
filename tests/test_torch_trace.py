"""PyTorch port, its own spans (`utils/trace.py::span`).

With no profiler running, no span reaches the profiler's record functions:
a dataset-generation deck runs end to end with them patched to raise.
Under `torch.profiler.profile` the same deck emits each case's build,
step and output spans, each inside its parent, one `luw.case.sample` per averaging
sample and one `luw.output.vtk` per VTK file, and writes the same bytes as
without the profiler.  A profile deck with the VK inlet emits one
`luw.vk.refresh` per step.  The decks are the examples at 16 m cells, f32.
"""

import shutil
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

# each span's parent: the innermost span that encloses it
PARENTS = {
    "luw.setup.case": {None},
    "luw.setup.release": {"luw.setup.case"},
    "luw.setup.flags": {"luw.setup.case"},
    "luw.setup.forcing": {"luw.setup.case"},
    "luw.setup.state": {"luw.setup.case"},
    "luw.case.calibrate": {None},
    "luw.case.chunk": {None},
    "luw.case.fields": {None},
    "luw.case.sample": {None},
    "luw.case.wait": {None, "luw.case.calibrate"},
    "luw.output": {None},
    "luw.output.copy": {"luw.output"},
    "luw.output.derived": {"luw.output"},
    "luw.output.vtk": {"luw.output"},
    "luw.vk.refresh": {"luw.case.calibrate", "luw.case.chunk"},
}


def _datagen_deck(dst: Path) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLES / "example_DatasetGen", dst)
    deck = load_deck(dst / "conf.luwdg")
    deck.set_text("case_parallel", "false")
    deck.set_text("lbm_storage", "f32")
    deck.set_float("cell_size", 16.0)
    deck.set_int("run_nstep", 30)
    deck.set_int("purge_avg", 10)
    deck.set_int("purge_avg_stride", 2)
    deck.save()
    return dst / "conf.luwdg"


def _profile_deck(dst: Path) -> Path:
    from latticeurbanwind_tpu_torch.deck import load_deck

    shutil.copytree(EXAMPLES / "example_ProfileResearch_noDEM", dst)
    deck = load_deck(dst / "conf.luwpf")
    deck.set_text("lbm_storage", "f32")
    deck.set_float("cell_size", 16.0)
    deck.set_list("angle", [0.0])
    deck.set_int("run_nstep", 60)
    deck.set_int("unsteady_output", 0)
    deck.set_int("purge_avg", 0)
    deck.save()
    return dst / "conf.luwpf"


def _run(deck: Path, cases: int = 0):
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    return run_deck(deck, device="cpu", quiet=True, max_cases=cases)


def _spans(prof):
    """(name, start ns, end ns) of the port's spans, start-sorted."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("luw.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parent(spans, i):
    """The innermost span enclosing spans[i] (None at the top)."""
    name, a, b = spans[i]
    best = None
    for j, (n, x, y) in enumerate(spans):
        if j != i and x <= a and b <= y and (best is None or y - x < best[2] - best[1]):
            best = (n, x, y)
    return best


def _files(results):
    return {f.name: f.read_bytes() for r in results for f in r.files}


def test_span_is_off_without_a_profiler():
    from latticeurbanwind_tpu_torch.utils.trace import span

    assert span("case.chunk") is span("output.vtk")
    with profile(activities=[ProfilerActivity.CPU]):
        assert span("case.chunk") is not span("case.chunk")
    assert span("case.chunk") is span("output.vtk")


def test_no_record_function_without_a_profiler(tmp_path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span reached the profiler with none running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    results = _run(_datagen_deck(tmp_path / "dg"), cases=2)
    assert [r.total_steps for r in results] == [30, 30]
    assert len(_files(results)) == 6


def test_datagen_deck_spans(tmp_path):
    plain = _files(_run(_datagen_deck(tmp_path / "plain"), cases=2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = _run(_datagen_deck(tmp_path / "traced"), cases=2)
    spans = _spans(prof)
    names = [n for n, _, _ in spans]

    for want in ("luw.setup.case", "luw.case.calibrate", "luw.case.chunk",
                 "luw.case.sample", "luw.output", "luw.output.copy",
                 "luw.output.vtk"):
        assert want in names, want
    assert names.count("luw.setup.case") == names.count("luw.output") == 2
    for i, (name, a, b) in enumerate(spans):
        parent = _parent(spans, i)
        assert (parent and parent[0]) in PARENTS[name], (name, parent)
        if parent is not None:
            assert parent[1] <= a and b <= parent[2], (name, parent)

    # every 2nd of the last 10 of 30 steps, in each case
    assert names.count("luw.case.sample") == 2 * 5
    vtks = [f for r in results for f in r.files if f.suffix == ".vtk"]
    assert names.count("luw.output.vtk") == len(vtks) == 6
    assert _files(results) == plain


def test_profile_deck_refreshes_the_inlet_once_a_step(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (result,) = _run(_profile_deck(tmp_path / "pf"))
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert result.total_steps == 60
    assert names.count("luw.vk.refresh") == 60
    for i, (name, _, _) in enumerate(spans):
        if name == "luw.vk.refresh":
            assert _parent(spans, i)[0] in PARENTS[name]


@pytest.mark.parametrize("stop_inside", [False, True])
def test_span_open_when_the_profiler_stops(stop_inside):
    """A span still open when the profiler stops (as the benchmark's traced
    stretch ends inside a chunk) closes without fault and is recorded."""
    from latticeurbanwind_tpu_torch.utils.trace import span

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    with span("case.chunk"):
        x = torch.ones(4).add_(1)
        if stop_inside:
            prof.__exit__(None, None, None)
    if not stop_inside:
        prof.__exit__(None, None, None)
    assert x.sum().item() == 8.0
    assert [n for n, _, _ in _spans(prof)] == ["luw.case.chunk"]
