"""A thermal cell of the NWP-coupled standard mode (`.luw`) added by files
and entries alone: a copy of the benchmark's data with one more
configuration (the example's prepared deck at 64 m, buoyancy on, its probe
column), its traffic file, a reference module of its own in `cases/` and
their BENCHMARK.json entries runs through the unchanged harness on the CPU,
in a window of steps that averages.  The reference here is a stand-in that
hands the program's own products back, so what is tested is the harness's
path through a thermal case: the case captured in the standard mode, the
thermal DDFs, initial T and temperature target carried to the check, the
fields pass and Welford's step at every sample, and a planted fault in one
thermal DDF failing `gdf_max` alone.  The warm-up puts a thermal case's
DDFs back bit for bit."""

import json
import shutil

import pytest
import torch

from luwbench import harness, spec
from luwbench.reference.state import raw_bits
from tiny import data_copy, run_tiny, shrink

NWP_INPUTS = spec.REPO / "examples" / "example_NWP-LBM_prepared"

NWP_CONFIG = {
    "name": "nwp-64m",
    "source": ("https://github.com/hweifluids/LatticeUrbanWind/tree/main/"
               "examples/example_NWP-LBM (conf.luw)"),
    "inputs": "nwp-64m",
    "deck_file": "conf.luw",
    "entry": "run_case",
    "reference": "nwp_standin",
    "deck": {
        "casename": "NwpDemo", "datetime": "20260101120000",
        "cut_lon_manual": [121.308, 121.34], "cut_lat_manual": [31.108, 31.132],
        "si_x_cfd": [0.0, 3052.427538], "si_y_cfd": [0.0, 2660.706659],
        "si_z_cfd": [0.0, 176.0], "base_height": 16.0, "z_limit": 160,
        "utm_crs": "EPSG:32651", "rotate_deg": 0.866094,
        "center_lon": 121.324, "center_lat": 31.12,
        "origin_shift_applied": True, "um_vol": [5.40791, 1.28189, 0.0],
        "um_bc": [4.902092, 1.274244, 0.0], "downstream_bc": "+x",
        "downstream_bc_yaw": 13.34, "n_gpu": [1, 1, 1],
        "mesh_control": "cell_size", "cell_size": 64.0, "validation": "pass",
        "high_order": False, "flux_correction": True, "run_nstep": 300,
        "purge_avg": 60, "purge_avg_stride": 2, "probes": ["center"],
        "coriolis_term": True, "enable_buffer_nudging": True,
        "buffer_thickness_m": 80, "buffer_tau_s": 300,
        "enable_top_sponge": True, "sponge_thickness_m": 60,
        "sponge_tau_s": 120, "turb_inflow_enable": True, "vk_inlet_ti": 0.05,
        "vk_inlet_nmodes": 64, "vk_inlet_seed": 100,
        "vk_inlet_update_stride": 4, "vk_inlet_stride_interpolation": True,
        "buoyancy": True,
    },
    "reduced": ["cell_size"],
    "tiny": {"deck": {}, "check": {}},
}

NWP_STEADY_T = {
    "config": "nwp-64m",
    "window": "steps",
    "why": "the thermal standard case averaging from its first step, its probe sampled",
    "deck": {"run_nstep": 1000000, "purge_avg": 1000000},
    "seed": {"deck_key": "vk_inlet_seed"},
    "warmup": {"steps": 24, "samples": 2},
    "check": {"rounds": 4, "steps": 2, "samples": True},
    "trace": {"from_s": 20, "seconds": 3},
    "limits": {"ddf_rms": 0.08, "ddf_max": 0.007, "gdf_rms": 0.08,
               "gdf_max": 0.007, "fbc_max": 0.0005, "avg_max": 0.001,
               "setup_max": 0.0005, "samples_gap": 0, "sample_max": 0.001},
}

STAND_IN = '''"""A stand-in reference of the thermal `.luw` cell: the program's own
products handed back, one thermal DDF shifted by SHIFT."""

from types import SimpleNamespace

import torch

from luwbench.reference.state import decode_ddf, encode_ddf
from luwbench.reference.step import FaceBC
from luwbench.reference.welford import AvgState

SHIFT = {shift!r}
STORAGE = {{torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
           torch.uint16: "fp16c"}}


def tables(prod, device):
    dyn = torch.zeros(8)
    dyn[3:6] = prod.coriolis
    fbc = None if prod.fbc_out is None else FaceBC(*prod.fbc_out[:6],
                                                   tt=prod.fbc_out[6])
    config = SimpleNamespace(storage=STORAGE[prod.fi_out.dtype], thermal=True,
                             omega=prod.omega, omega_t=prod.omega_t)
    return SimpleNamespace(
        shape=tuple(prod.flags.shape), flags=prod.flags.numpy(),
        u0=prod.u0.numpy(), T0=prod.T0.numpy(),
        forcing=SimpleNamespace(**prod.forcing), config=config,
        dyn=dyn.to(device), fbc0=SimpleNamespace(tt=prod.tt), vk=None,
        fbc=fbc, avg=prod.avg_out)


def follow(tables, prod, rounds, steps, device, low=False):
    gi = prod.gi_out.clone()
    z, y, x = (s // 2 for s in gi.shape[1:])
    g = decode_ddf(gi[3], tables.config.storage)
    g[z, y, x] += SHIFT
    gi[3] = encode_ddf(g, tables.config.storage)
    return prod.fi_out, gi, tables.fbc


def average(tables, samples, device, low=False):
    return AvgState(len(samples), *tables.avg)


def sample(sample, tables, device, low=False):
    return sample["after"]
'''


def _nwp_copy(tmp_path, shift=0.0):
    """(root, BENCHMARK.json) of a copy of the benchmark's data with the
    thermal cell `nwp-64m.steady-t` added by files and entries."""
    root = data_copy(tmp_path)
    shutil.copytree(NWP_INPUTS, root / "configs" / "nwp-64m")
    (root / "configs" / "nwp-64m.json").write_text(json.dumps(NWP_CONFIG))
    (root / "workloads" / "nwp-64m.steady-t.json").write_text(
        json.dumps(NWP_STEADY_T))
    (root / "cases" / "nwp_standin.py").write_text(STAND_IN.format(shift=shift))
    bench = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "nwp-64m", "source": NWP_CONFIG["source"],
        "file": "luwbench/configs/nwp-64m.json", "reduced": ["cell_size"],
        "why": "the NWP-coupled standard mode: buoyancy on D3Q7, Coriolis, a probe"})
    bench["workloads"].append({
        "name": "nwp-64m.steady-t", "config": "nwp-64m", "traffic": "steady-t",
        "chips": 1, "why": "the thermal standard case averaging with its probe"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "profile-1p5m.avg" in m.get("workloads", ()):
            m["workloads"].append("nwp-64m.steady-t")
    return root, bench


def _no_fused_pass(monkeypatch):
    """The fused averaging pass made to fail: a thermal case with probes
    must take the fields pass and Welford's step at every sample."""
    from latticeurbanwind_tpu_torch.ops import avg_kernel
    from latticeurbanwind_tpu_torch.run import driver

    def fused(*a, **kw):
        raise AssertionError("the fused averaging pass ran on a thermal case")

    monkeypatch.setattr(avg_kernel, "avg_update", fused)
    monkeypatch.setattr(driver, "avg_update", fused)


@pytest.mark.parametrize("shift", [0.0, 0.05], ids=["sound", "gi-shifted"])
def test_thermal_cell_added_from_files(shift, tmp_path, monkeypatch):
    _no_fused_pass(monkeypatch)
    root, bench = _nwp_copy(tmp_path, shift)
    cell = shrink(spec.cell("nwp-64m.steady-t", bench, root))
    assert "mlups" in cell.end_to_end and "ksc_roofline" in cell.per_layer
    run, result, line = run_tiny(cell, tmp_path / "work", seconds=1.5)
    compared = line["compared"]
    assert set(compared) == set(NWP_STEADY_T["limits"])
    assert run.steps > 0 and run.samples > 0 and run.cases_done == 0
    assert run.work["ksc_step_s"] > 0
    failed = sorted(k for k, c in compared.items() if c["value"] > c["limit"])
    if shift:
        assert not result.correct and failed == ["gdf_max"], compared
        assert compared["gdf_max"]["value"] == pytest.approx(shift, rel=0.02)
    else:
        assert result.correct, compared
        assert all(c["value"] == 0.0 for c in compared.values()), compared


def test_warm_up_puts_thermal_ddfs_back(tmp_path):
    root, bench = _nwp_copy(tmp_path)
    cell = shrink(spec.cell("nwp-64m.steady-t", bench, root))
    keys = harness.deck_keys(cell, 2147483801)
    deck = harness.write_deck(cell, keys, tmp_path, "case")
    captured = {}
    with harness.instrumented(harness.Probe(),
                              capture=lambda c: captured.setdefault("case", c)):
        with pytest.raises(harness.Captured):
            from latticeurbanwind_tpu_torch.run import modes

            modes.run_deck(deck, device="cpu", quiet=True, max_cases=1)
    case = captured["case"]
    assert case.config.thermal and case.probes and case.state.gi is not None
    built = [t.clone() for t in (case.state.fi, case.state.gi)]
    harness.warm_up(case, cell.workload["warmup"], [torch.device("cpu")])
    for t, b in zip((case.state.fi, case.state.gi), built):
        assert torch.equal(raw_bits(t), raw_bits(b))
