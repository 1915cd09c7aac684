"""PyTorch port, `dgprepare` and `buildingscale` against the JAX package and
the examples.

The port's dgprepare on copies of `examples/example_ProfileResearch_noDEM`
and `examples/example_DatasetGen` with their `proj_temp/*.stl` removed
writes the case STL and the deck byte for byte as the JAX package's
dgprepare writes them on other copies, and as the examples ship them.
`buildingscale` prints the JAX package's statistics on the made cases, and
`morphology_stats` returns its values on seeded solids.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = {"profile": ("example_ProfileResearch_noDEM", "conf.luwpf",
                        "CityDemo_PF.stl"),
            "datagen": ("example_DatasetGen", "conf.luwdg", "BlockDemo_DG.stl")}


def _bare_copy(src: Path, dst: Path) -> Path:
    shutil.copytree(src, dst)
    for stl in (dst / "proj_temp").glob("*.stl"):
        stl.unlink()
    return dst


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_dgprepare_writes_the_shipped_case(tmp_path, example, capsys):
    from latticeurbanwind_tpu.post.buildingscale import main as jax_scale
    from latticeurbanwind_tpu.pre.dgprepare import main as jax_prepare
    from latticeurbanwind_tpu_torch.cli.dispatch import main as dispatch

    name, deck, stl = EXAMPLES[example]
    shipped = REPO / "examples" / name
    homes = {s: _bare_copy(shipped, tmp_path / s) for s in ("jax", "port")}
    assert jax_prepare([str(homes["jax"] / deck)]) == 0
    assert dispatch(["dgprepare", str(homes["port"] / deck)]) == 0
    for rel in (deck, f"proj_temp/{stl}"):
        port = (homes["port"] / rel).read_bytes()
        assert port == (homes["jax"] / rel).read_bytes(), rel
        assert port == (shipped / rel).read_bytes(), rel
    printed = {}
    capsys.readouterr()
    for side, fn in (("jax", jax_scale),
                     ("port", lambda a: dispatch(["buildingscale", *a]))):
        assert fn([str(homes[side] / deck)]) == 0
        printed[side] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and "lambda_p" in printed["port"]


def test_dgprepare_refusals(tmp_path, capsys):
    from latticeurbanwind_tpu.pre.dgprepare import main as jax_prepare
    from latticeurbanwind_tpu_torch.pre.dgprepare import main

    for side, fn in (("jax", jax_prepare), ("port", main)):
        home = tmp_path / side
        (home / "building_db").mkdir(parents=True)
        (home / "conf.luw").write_text("casename = x\n")
        (home / "conf.luwpf").write_text("casename = x\nbase_height = 0\n")
        (home / "ok.luwdg").write_text("casename = x\nbase_height = 5\n"
                                       "x_exp_rat = 2\ny_exp_rat = 2\nz_limit = 50\n")
        assert [fn([]), fn([str(home / "conf.luw")]), fn([str(home / "conf.luwpf")]),
                fn([str(home / "ok.luwdg")])] == [2, 2, 1, 1]
    out = capsys.readouterr().out
    assert out.count("base_height missing or non-positive") == 2
    assert out.count("no STL under") == 2


def test_morphology_stats(tmp_path):
    from latticeurbanwind_tpu.post.buildingscale import morphology_stats as jax_stats
    from latticeurbanwind_tpu_torch.post.buildingscale import morphology_stats

    solid = np.zeros((10, 8, 8), dtype=bool)
    solid[0] = True
    solid[1:6, 2:4, 2:4] = True
    stats = morphology_stats(solid, cell_m=10.0, ground_k=1)
    assert stats == jax_stats(solid, cell_m=10.0, ground_k=1)
    assert stats["lambda_p"] == pytest.approx(4 / 64)
    assert stats["built_columns"] == 4 and stats["lambda_f_x"] > 0
    rng = np.random.default_rng(4)
    for k in (0, 1, 3):
        solid = rng.random((12, 9, 11)) < 0.3
        assert morphology_stats(solid, 2.5, k) == jax_stats(solid, 2.5, k)
    assert morphology_stats(np.zeros((4, 3, 3), bool), 1.0) == \
        jax_stats(np.zeros((4, 3, 3), bool), 1.0)
