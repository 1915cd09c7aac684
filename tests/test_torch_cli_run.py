"""PyTorch port, the prerun validation gate of `runluw` (`cli/run.py`)
against the JAX package's.

A `.luw` deck whose `validation` is not `pass` is refused before any solve
with the JAX package's line and exit code 1, unless `--force` is given;
`.luwpf` and `.luwdg` decks are not gated.  `run_deck` is replaced in both
packages by a stub that records the call, so no deck is solved here.
"""

from pathlib import Path

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

CASES = [  # (deck name, validation line, extra args, runs, printed status)
    ("conf.luw", "validation = error\n", [], False, "error"),
    ("conf.luw", "", [], False, "missing"),
    ("conf.luw", "validation = ERROR\n", [], False, "error"),
    ("conf.luw", "validation = pass\n", [], True, None),
    ("conf.luw", "validation = error\n", ["--force"], True, None),
    ("conf.luw", "validation = pass\n", ["--force"], True, None),
    ("conf.luwpf", "validation = error\n", [], True, None),
    ("conf.luwdg", "", [], True, None),
]


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' run_deck replaced: the calls land in the list."""
    import latticeurbanwind_tpu.run as jax_run
    import latticeurbanwind_tpu_torch.run.modes as port_modes

    calls = []

    def stub(side):
        def run_deck(path, **kw):
            calls.append((side, Path(path).name))
            return []
        return run_deck

    monkeypatch.setattr(jax_run, "run_deck", stub("jax"))
    monkeypatch.setattr(port_modes, "run_deck", stub("port"))
    return calls


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("name, line, extra, runs, status", CASES)
def test_validation_gate(tmp_path, capsys, stubbed, side, name, line, extra,
                         runs, status):
    from latticeurbanwind_tpu.cli.run import main as jax_main
    from latticeurbanwind_tpu_torch.cli.run import main as port_main

    deck = tmp_path / name
    deck.write_text(f"casename = gate\n{line}")
    args = [str(deck), *extra] + (["--device", "cpu"] if side == "port" else [])
    rc = (jax_main if side == "jax" else port_main)(args)
    out = capsys.readouterr().out
    if runs:
        assert rc == 0 and stubbed == [(side, name)]
        assert "0 case(s) complete" in out
    else:
        assert rc == 1 and stubbed == []
        assert out == (f"ERROR: deck validation status is '{status}' "
                       "(run luwval first, or pass --force)\n")


def test_gate_lines_are_the_jax_lines(tmp_path, capsys, stubbed):
    from latticeurbanwind_tpu.cli.run import main as jax_main
    from latticeurbanwind_tpu_torch.cli.dispatch import main as dispatch

    for text in ("validation = fail\n", "validation = \n", "validation = Pass\n"):
        (tmp_path / "conf.luw").write_text(f"casename = g\n{text}")
        rcs = (jax_main([str(tmp_path / "conf.luw")]),
               dispatch(["runluw", str(tmp_path / "conf.luw"), "--device", "cpu"]))
        jax_out, port_out = capsys.readouterr().out.split("\n", 1)
        assert rcs[0] == rcs[1]
        assert port_out.startswith(jax_out.replace("runluw:", "runluw-torch:"))


def test_summary_prints_this_runs_launches(tmp_path, capsys, monkeypatch):
    """runluw's summary ends with the kernel launches of its own run: the
    counters' advance across `run_deck`, not their totals."""
    import json

    import latticeurbanwind_tpu_torch.run.modes as port_modes
    from latticeurbanwind_tpu_torch.cli.run import launch_counts, main
    from latticeurbanwind_tpu_torch.ops.avg_kernel import avg_update
    from latticeurbanwind_tpu_torch.ops.stream_collide import stream_collide, vk_sites

    def run_deck(path, **kw):          # as a run with sites and 2 samples would
        stream_collide.launches += 3
        stream_collide.launches_vk += 3
        vk_sites.launches += 3
        avg_update.launches += 2
        return []

    monkeypatch.setattr(port_modes, "run_deck", run_deck)
    for counter, name in ((stream_collide, "launches"), (stream_collide, "launches_vk"),
                          (vk_sites, "launches"), (avg_update, "launches")):
        monkeypatch.setattr(counter, name, 5)
    (tmp_path / "conf.luwpf").write_text("casename = c\n")
    assert main([str(tmp_path / "conf.luwpf"), "--device", "cpu"]) == 0
    last = capsys.readouterr().out.rstrip("\n").rsplit("\n", 1)[-1]
    tag = "runluw-torch: kernel launches "
    assert last.startswith(tag)
    got = json.loads(last[len(tag):])
    assert sorted(got) == sorted(launch_counts())
    assert got == {k: {"stream_collide": 3, "stream_collide_vk": 3, "vk_sites": 3,
                       "avg_update": 2}.get(k, 0) for k in got}
