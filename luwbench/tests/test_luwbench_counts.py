"""The frozen work counts equal PERF.md section 3's bound (chip_smoke.py's
`step_bound` and `avg_bound`) at the two grids, with what each deck gives
the case: its forcing and the faces of its inlet."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from luwbench import counts, spec

# grid, nudge, sponge, the inlet's faces: as the reference rebuilds each deck
GRIDS = {"profile-1p5m": ((118, 424, 424), True, True, ("ue", "un", "us", "uw")),
         "datagen-2m": ((68, 270, 270), True, False, ())}


def _stand_ins(shape, sponge, faces, live):
    """The state, forcing, FaceBC and site masks of a case at `shape` as
    meta tensors (sizes only), with `live` cells that are not solid."""
    Z, Y, X = shape
    flags = torch.zeros(Z * Y * X, dtype=torch.uint8)
    flags[live:] = 1                                   # TYPE_S
    meta = dict(device="meta")
    st = SimpleNamespace(flags=flags.view(Z, Y, X), gi=None,
                         fi=torch.empty((19, Z, Y, X), dtype=torch.bfloat16, **meta))
    frc = SimpleNamespace(
        nudge_sigma=torch.empty(shape, dtype=torch.float32, **meta),
        nudge_face=torch.empty(shape, dtype=torch.uint8, **meta),
        sponge_sigma_z=(torch.empty(Z, dtype=torch.float32, **meta)
                        if sponge else None))
    fbc = [torch.empty(s, dtype=torch.float32, **meta) for s in
           ((Z, 3, Y), (Z, 3, Y), (Z, 3, X), (Z, 3, X), (3, Y, X), (3, Y, X))]
    mask = {"uw": (Z, 1, Y), "ue": (Z, 1, Y), "us": (Z, 1, X), "un": (Z, 1, X)}
    spec_ = {"masks": {f: torch.empty(mask[f], dtype=torch.float32, **meta)
                       for f in faces}} if faces else None
    tables = SimpleNamespace(
        shape=shape, flags=flags.view(Z, Y, X).numpy(),
        config=SimpleNamespace(storage="bf16"), forcing=frc,
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
