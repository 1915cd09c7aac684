"""The readers on a hand-made trace: busy time is the union of a card's
operations, a roofline share is the least time over the device time, and a
reader with nothing to read returns None."""

import pytest

from luwbench import spec
from luwbench.harness import CaseRecord, Run
from luwbench.trace import Trace

KSC = "void luw::stream_collide_tiled_kernel<luw::CodecBF16>"
SITES = "void luw::vk_site_kernel<luw::CodecBF16>"
KAVG = "void (anonymous namespace)::avg_update_kernel<luw::CodecBF16, 0>"


def _run(trace=None, **kw):
    cell = spec.cell("profile-1p5m.avg")
    run = Run(cell=cell, traced=trace is not None, trace=trace,
              work={"ksc_step_s": 0.5e-3, "kavg_sample_s": 0.45e-3}, **kw)
    return run


def _trace():
    ops = [(KSC, 0, 0.000, 0.001), (SITES, 0, 0.001, 0.0011),
           (KAVG, 0, 0.0011, 0.0020), ("memcpy", 0, 0.0015, 0.0016),
           (KSC, 0, 0.0030, 0.0040), (SITES, 0, 0.0040, 0.0041)]
    return Trace(window_s=0.005, devices=(0,), device_ops=ops,
                 spans=[("run_case", 0.0, 0.005)],
                 host_ops=[("aten::bmm", 0.0021, 0.0029)])


def test_busy_is_the_union():
    t = _trace()
    assert t.busy_s(0) == pytest.approx(0.0031)
    assert t.idle_gaps(1) == [["run_case / aten::bmm", pytest.approx(0.001)]]


def test_rooflines_and_idle():
    run = _run(_trace(), trace_steps=2)
    ksc = spec.reader("ksc_roofline").read(run)
    assert ksc == pytest.approx(100 * 2 * 0.5e-3 / 0.0022)
    assert spec.reader("kavg_roofline").read(run) == pytest.approx(50.0)
    assert spec.reader("device_idle_pct").read(run) == pytest.approx(38.0)
    assert spec.reader("device_ops_per_step").read(run) == pytest.approx(3.0)


def test_nothing_to_read_is_none():
    run = _run()
    for name in ("ksc_roofline", "kavg_roofline", "device_idle_pct",
                 "device_ops_per_step", "vk_host_ms", "mlups", "case_s",
                 "solve_s.sweep", "case_setup_s.sweep", "output_s.sweep"):
        assert spec.reader(name).read(run) is None, name


def test_case_readers():
    cases = [CaseRecord(enter=1.0, exit=9.0, solver_seconds=6.5, prefix="DG_4_0_"),
             CaseRecord(enter=10.0, exit=18.5, solver_seconds=6.6, prefix="DG_4_22.5_")]
    run = _run(cases=cases, cases_done=2, window_start=0.0, window_s=18.5)
    assert spec.reader("case_s").read(run) == pytest.approx(9.25)
    assert spec.reader("solve_s.sweep").read(run) == pytest.approx(6.55)
    assert spec.reader("output_s.sweep").read(run) == pytest.approx(1.7)
    assert spec.reader("case_setup_s.sweep").read(run) == pytest.approx(1.0)
