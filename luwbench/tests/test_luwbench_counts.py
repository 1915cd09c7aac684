"""The frozen work counts equal PERF.md section 3's bound (chip_smoke.py's
`step_bound` and `avg_bound`) at the two grids, with what each deck gives
the case: its forcing and the faces of its inlet; a thermal step adds the
D3Q7 DDFs, the temperature target and 60 operations a cell; the cells'
own counts hold to the byte."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from luwbench import counts, spec

# grid, nudge, sponge, the inlet's faces: as the reference rebuilds each deck
GRIDS = {"profile-1p5m": ((118, 424, 424), True, True, ("ue", "un", "us", "uw")),
         "datagen-2m": ((68, 270, 270), True, False, ())}


def _stand_ins(shape, sponge, faces, live, thermal=False):
    """The state, forcing, FaceBC and site masks of a case at `shape` as
    meta tensors (sizes only), with `live` cells that are not solid."""
    Z, Y, X = shape
    flags = torch.zeros(Z * Y * X, dtype=torch.uint8)
    flags[live:] = 1                                   # TYPE_S
    meta = dict(device="meta")
    st = SimpleNamespace(
        flags=flags.view(Z, Y, X),
        gi=(torch.empty((7, Z, Y, X), dtype=torch.bfloat16, **meta)
            if thermal else None),
        fi=torch.empty((19, Z, Y, X), dtype=torch.bfloat16, **meta))
    frc = SimpleNamespace(
        nudge_sigma=torch.empty(shape, dtype=torch.float32, **meta),
        nudge_face=torch.empty(shape, dtype=torch.uint8, **meta),
        sponge_sigma_z=(torch.empty(Z, dtype=torch.float32, **meta)
                        if sponge else None))
    fbc = [torch.empty(s, dtype=torch.float32, **meta) for s in
           ((Z, 3, Y), (Z, 3, Y), (Z, 3, X), (Z, 3, X), (3, Y, X), (3, Y, X))
           + (((Y, X),) if thermal else ())]
    mask = {"uw": (Z, 1, Y), "ue": (Z, 1, Y), "us": (Z, 1, X), "un": (Z, 1, X)}
    spec_ = {"masks": {f: torch.empty(mask[f], dtype=torch.float32, **meta)
                       for f in faces}} if faces else None
    tables = SimpleNamespace(
        shape=shape, flags=flags.view(Z, Y, X).numpy(),
        config=SimpleNamespace(storage="bf16", thermal=thermal), forcing=frc,
        vk=SimpleNamespace(kernel_spec=spec_) if faces else None)
    return st, frc, fbc, spec_, tables


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_counts_equal_perf_md_bound(name):
    import chip_smoke

    shape, nudge, sponge, faces = GRIDS[name]
    assert tuple(spec.config(name)["grid"]) == shape
    live = int(0.9 * np.prod(shape))
    st, frc, fbc, spec_, tables = _stand_ins(shape, sponge, faces, live)
    want = chip_smoke.step_bound(st, frc, fbc, spec_)
    got = counts.least_seconds(
        counts.ksc_step_bytes(shape, live, storage_bytes=2, nudge=nudge,
                              sponge=sponge, site_faces=faces),
        counts.ksc_step_flops(live))
    assert got["bound_by"] == want["bound_by"] == "bytes"
    assert got["seconds"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    want_avg = chip_smoke.avg_bound(st)
    got_avg = counts.least_seconds(
        counts.kavg_sample_bytes(shape, live, storage_bytes=2),
        counts.kavg_sample_flops(live))
    assert got_avg["seconds"] * 1e3 == pytest.approx(want_avg["bound_ms"], rel=1e-12)
    w = counts.work_of(tables)
    assert w["ksc_step_s"] == got["seconds"]
    assert w["kavg_sample_s"] == got_avg["seconds"]


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_work_follows_the_deck(name, tmp_path):
    """What `work_of` reads from the reference's case of each deck (at a
    coarse cell): the forcing present and the inlet's faces."""
    from luwbench import harness
    from luwbench.reference import setup as ref_setup
    from tiny import tiny_cell

    _, nudge, sponge, faces = GRIDS[name]
    cell = tiny_cell(next(w["name"] for w in spec.benchmark()["workloads"]
                          if w["config"] == name))
    keys = harness.deck_keys(cell, 7)
    deck = harness.write_deck(cell, keys, tmp_path, "case")
    cpu = torch.device("cpu")
    tables = (ref_setup.profile_case(deck, 0.0, cpu) if name.startswith("profile")
              else ref_setup.datagen_case(deck, 4.0, 0.0, cpu))
    assert (tables.forcing.nudge_sigma is not None) == nudge
    assert (tables.forcing.sponge_sigma_z is not None) == sponge
    got = () if tables.vk is None else tuple(sorted(tables.vk.kernel_spec["masks"]))
    assert got == faces
    assert tables.config.storage == "bf16"
    w = counts.work_of(tables)
    assert w["ksc_step_s"] > 0 and w["kavg_sample_s"] > 0


def test_peaks_are_the_data_sheets():
    import chip_smoke

    assert counts.PEAK_BYTES_PER_S == chip_smoke.PEAK_BYTES_PER_S == 3.35e12
    assert counts.PEAK_F32_FLOPS == chip_smoke.PEAK_F32_FLOPS == 67e12


# the thermal standard deck at 3 m (ROADMAP's K7 rows): grid, the inlet's faces
NWP_3M = ((79, 887, 1017), ("ue", "un", "us", "uw"))


def test_thermal_step_adds_the_d3q7_work():
    """A thermal table adds the 7 D3Q7 DDFs by the D3Q19 rule, the
    temperature target read once and 60 operations a cell that is not
    solid, and equals chip_smoke.py's thermal bound."""
    import chip_smoke

    shape, faces = NWP_3M
    Z, Y, X = shape
    live = int(0.9 * np.prod(shape))
    kw = dict(storage_bytes=2, nudge=True, sponge=True, site_faces=faces)
    added = (counts.ksc_step_bytes(shape, live, thermal=True, **kw)
             - counts.ksc_step_bytes(shape, live, **kw))
    assert added == 7 * 2 * (Z * Y * X + live) + 4 * Y * X
    assert (counts.ksc_step_flops(live, thermal=True)
            - counts.ksc_step_flops(live)) == 60 * live
    st, frc, fbc, spec_, tables = _stand_ins(shape, True, faces, live,
                                             thermal=True)
    want = chip_smoke.step_bound(st, frc, fbc, spec_)
    got = counts.least_seconds(
        counts.ksc_step_bytes(shape, live, thermal=True, **kw),
        counts.ksc_step_flops(live, thermal=True))
    assert got["bound_by"] == want["bound_by"] == "bytes"
    assert got["seconds"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    assert counts.work_of(tables)["ksc_step_s"] == got["seconds"]


# each cell's tiny tables at seed 7: shape, cells not solid, K-SC bytes and
# operations, K-AVG bytes, and `work_of`, as counted before the thermal term
BEFORE = {
    "profile-1p5m.steady": ((11, 40, 40), 14320, 1385164, 8592000, 1134560,
                            {"ksc_step_s": 4.134817910447761e-07,
                             "kavg_sample_s": 3.3867462686567164e-07}),
    "profile-1p5m.avg": ((11, 40, 40), 14320, 1385164, 8592000, 1134560,
                         {"ksc_step_s": 4.134817910447761e-07,
                          "kavg_sample_s": 3.3867462686567164e-07}),
    "datagen-2m.sweep": ((7, 27, 27), 4314, 415032, 2588400, 341595,
                         {"ksc_step_s": 1.2389014925373133e-07,
                          "kavg_sample_s": 1.0196865671641791e-07}),
}


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_cells_work_unchanged(name, tmp_path):
    """The cells' tables, as each configuration's reference rebuilds them,
    give the counts they gave before the thermal term, to the byte."""
    from luwbench import harness
    from tiny import tiny_cell

    shape, live, nbytes, flops, avg_bytes, work = BEFORE[name]
    cell = tiny_cell(name)
    keys = harness.deck_keys(cell, 7)
    deck = harness.write_deck(cell, keys, tmp_path, "case")
    prefix = ("" if "inflow" not in keys else
              f"DG_{keys['inflow'][0]:g}_{keys['angle'][0]:g}_")
    tables = cell.reference.tables(SimpleNamespace(deck=deck, prefix=prefix),
                                   torch.device("cpu"))
    assert tuple(tables.shape) == shape and not tables.config.thermal
    assert int(((tables.flags & 1) == 0).sum()) == live
    spec_ = None if tables.vk is None else tables.vk.kernel_spec
    assert counts.ksc_step_bytes(
        shape, live, storage_bytes=2,
        nudge=tables.forcing.nudge_sigma is not None,
        sponge=tables.forcing.sponge_sigma_z is not None,
        site_faces=sorted(spec_["masks"]) if spec_ else ()) == nbytes
    assert counts.ksc_step_flops(live) == flops
    assert counts.kavg_sample_bytes(shape, live, storage_bytes=2) == avg_bytes
    assert counts.work_of(tables) == work
