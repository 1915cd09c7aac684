"""The port's own spans (`luw.<name>`) in the benchmark's trace, and the
readers that read them (`spans.py`, six metrics).

`Tracer.stop` keeps them as host operations under their full names: they
are host events of function scope with no mirror on the device, so the
device operations and every existing reader read as on the same events
without them.  Device time goes to the span that launched it by pairing
launch calls with the card's operations in order from the last, and the
kernels' names carry the side past a lost record; a pairing that cannot
hold reads None.  A tiny sweep on the CPU, traced, gives the sweep's readers
their spans.
"""

import time

import pytest
import torch

from luwbench import spans, spec
from luwbench.harness import Run
from luwbench.trace import Trace, Tracer

KSC = "void luw::stream_collide_tiled_kernel<luw::CodecBF16>"
SITES = "void luw::vk_site_kernel<luw::CodecBF16>"
KAVG = "void (anonymous namespace)::avg_update_kernel<luw::CodecBF16, 0>"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n"
ADD = "void at::native::vectorized_elementwise_kernel<4>"


class _Event:
    def __init__(self, name, kind, start_us, dur_us, index=0):
        self._n, self._k = name, kind
        self._a, self._d, self._i = int(start_us * 1000), int(dur_us * 1000), index

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._k}"

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_index(self):
        return self._i


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _: events})()

    def __exit__(self, *a):
        return False


def _stop(events) -> Trace:
    """`Tracer.stop` on `events` for card 0, without a card to wait for; a
    start later than the stop leaves the window to the card's span."""
    tr = Tracer((0,))
    tr._sync = lambda: None
    tr.prof, tr.t0 = _Prof(events), time.perf_counter() + 60.0
    return tr.stop()


def _step_events(with_spans: bool, steps: int = 2):
    """Profile steps as the profiler records them (us): each the
    inlet's refresh (two launches: a GEMM, an add) then K-SC and its site
    pass; the card runs each step well after the host enqueued it."""
    ev = [_Event("luwbench.vk_refresh", "CPU", 0, 30),
          _Event("luwbench.vk_refresh", "CUDA", 100, 40)]      # its mirror
    for k in range(steps):
        t = 200 * k
        if with_spans:
            ev.append(_Event("luw.vk.refresh", "CPU", t + 1, 28))
        ev += [_Event("aten::bmm", "CPU", t + 2, 10),
               _Event("cudaLaunchKernelExC", "CPU", t + 5, 4),
               _Event("cudaLaunchKernel", "CPU", t + 20, 4),
               _Event("cudaLaunchKernel", "CPU", t + 40, 4),
               _Event("cudaLaunchKernel", "CPU", t + 45, 4)]
        d = 100 + 200 * k
        ev += [_Event(GEMM, "CUDA", d, 20), _Event(ADD, "CUDA", d + 25, 5),
               _Event(KSC, "CUDA", d + 40, 100), _Event(SITES, "CUDA", d + 141, 9)]
    ev.append(_Event("cudaStreamSynchronize", "CPU", 200 * steps + 60, 5))
    ev.append(_Event("Stream Sync", "CUDA", 200 * steps + 60, 5))
    return ev


def _run(trace, cell="profile-1p5m.steady", **kw):
    return Run(cell=spec.cell(cell), traced=True, trace=trace,
               work={"ksc_step_s": 50e-6, "kavg_sample_s": 45e-6}, **kw)


def test_program_spans_stay_on_the_host():
    plain, traced = _stop(_step_events(False)), _stop(_step_events(True))
    assert traced.device_ops == plain.device_ops
    assert len(traced.device_ops) == 8
    assert [n for n, _, _ in traced.host_ops].count("luw.vk.refresh") == 2
    assert [n for n, _, _ in traced.spans] == ["vk_refresh"]
    assert traced.spans == plain.spans
    assert traced.window_s == plain.window_s


@pytest.mark.parametrize("name", ["ksc_roofline", "device_ops_per_step",
                                  "device_idle_pct", "device_idle_pct.sweep",
                                  "kavg_roofline"])
def test_existing_readers_read_alike(name):
    """On the same device operations, an existing reader reads the same
    with the program's spans in the trace as without them."""
    plain, traced = _stop(_step_events(False)), _stop(_step_events(True))
    reader = spec.reader(name)
    assert reader.read(_run(traced, trace_steps=2)) == \
        reader.read(_run(plain, trace_steps=2))


def test_gaps_are_named_by_the_program_span():
    """A gap is named by the innermost span or operation on the host at its
    middle: the program's span where the host runs Python inside it."""
    plain, traced = _stop(_step_events(False)), _stop(_step_events(True))
    assert [g[1] for g in traced.idle_gaps()] == [g[1] for g in plain.idle_gaps()]
    trace = Trace(window_s=3.0, devices=(0,),
                  device_ops=[(KSC, 0, 0.0, 1.0), (KSC, 0, 2.0, 3.0)],
                  spans=[("write_outputs", 1.0, 2.0)],
                  host_ops=[("luw.output", 1.0, 2.0), ("luw.output.vtk", 1.2, 1.8),
                            ("aten::copy_", 1.1, 1.2)])
    assert trace.idle_gaps() == [["write_outputs / luw.output.vtk", 1.0]]


def test_device_time_goes_to_the_span_that_launched_it():
    trace = _stop(_step_events(True))
    # the GEMM and the add of each step: (20 + 5) us, twice
    assert spans.launched_within(trace, "vk.refresh") == pytest.approx(50e-6)
    line = spec.reader("vk_device_ms").read(_run(trace, trace_steps=2))
    assert line == pytest.approx(25e-3)


def test_lost_first_records_pair_from_the_end():
    """The profiler may lose the first records of a stretch, of operations
    or of calls: the rest pair from the last, and the kernels' names give
    the unpaired operations their side."""
    no_gemm = _drop(_step_events(True), GEMM, 100)
    assert spans.launched_within(_stop(no_gemm), "vk.refresh") == pytest.approx(30e-6)
    no_calls = [e for e in _step_events(True)
                if not (e.name().startswith("cudaLaunch") and e.start_ns() < 30_000)]
    assert spans.launched_within(_stop(no_calls), "vk.refresh") == pytest.approx(50e-6)
    # an operation at the end with no call: nothing pairs in order
    more_ops = _stop(_step_events(True) + [_Event(ADD, "CUDA", 455, 1)])
    assert spans.launched_within(more_ops, "vk.refresh") is None


def _drop(events, name, start_us):
    return [e for e in events
            if not (e.name() == name and e.start_ns() == int(start_us * 1000))]


def _copy_step_events(steps: int = 2):
    """`_step_events` with a copy to the host after each step: a
    `cudaMemcpyAsync` at 150 us into the step, its operation on the card
    after the site pass."""
    ev = _step_events(True, steps)
    for k in range(steps):
        ev += [_Event("cudaMemcpyAsync", "CPU", 200 * k + 150, 4),
               _Event("Memcpy DtoH (Device -> Pageable)", "CUDA", 200 * k + 251, 2)]
    return ev


def test_a_record_lost_in_mid_stretch():
    """A record lost in mid-stretch stops the pairing there: where at least
    half the operations paired after it, the kernels' names give the
    earlier ones their side; else the reading is None."""
    whole = _stop(_copy_step_events(6))
    assert spans.launched_within(whole, "vk.refresh") == pytest.approx(150e-6)
    # the second step's GEMM lost: its copy meets the GEMM's call
    early = _stop(_drop(_copy_step_events(6), GEMM, 300))
    assert spans.launched_within(early, "vk.refresh") == pytest.approx(130e-6)
    late = _stop(_drop(_copy_step_events(6), GEMM, 900))
    assert spans.launched_within(late, "vk.refresh") is None
    # the card waits on the host: each operation starts 1 us after its call,
    # and the lost record leaves an operation before the call it meets
    waits = [_Event("luw.vk.refresh", "CPU", 0, 100)]
    for k in range(4):
        waits += [_Event("cudaLaunchKernel", "CPU", 20 * k, 2),
                  _Event(ADD, "CUDA", 20 * k + 1, 5)]
    assert spans.launched_within(_stop(waits), "vk.refresh") == pytest.approx(20e-6)
    assert spans.launched_within(_stop(_drop(waits, ADD, 21)), "vk.refresh") == \
        pytest.approx(15e-6)
    assert spans.launched_within(_stop(_drop(waits, ADD, 41)), "vk.refresh") is None


def test_a_pairing_that_cannot_hold_reads_none():
    """Where the operations of the stretch's end do not pair, where a
    kernel name is launched both inside the spans and outside, or where
    the calls cannot be told apart by card, the reading is None, not a
    wrong number."""
    # a second card's add, launched inside a span: it would pair
    two = _stop(_step_events(True) + [_Event("cudaLaunchKernel", "CPU", 10, 2),
                                      _Event(ADD, "CUDA", 126, 1, index=1)])
    assert spans.launched_within(two, "vk.refresh") is None
    # a kernel whose only operation is before the first call
    unpaired = _step_events(True) + [_Event("void other_kernel", "CUDA", 2, 1)]
    assert spans.launched_within(_stop(unpaired), "vk.refresh") is None
    # the last site pass's call a copy's
    swapped = [_Event("cudaMemcpyAsync", "CPU", 245, 4)
               if e.name() == "cudaLaunchKernel" and e.start_ns() == 245_000 else e
               for e in _step_events(True)]
    assert spans.launched_within(_stop(swapped), "vk.refresh") is None
    # the last operation before its call
    early = _step_events(True) + [_Event("cudaLaunchKernel", "CPU", 455, 2),
                                  _Event(ADD, "CUDA", 450, 1)]
    assert spans.launched_within(_stop(early), "vk.refresh") is None
    both = _copy_step_events() + [_Event("cudaLaunchKernel", "CPU", 46, 2),
                                  _Event(ADD, "CUDA", 250, 1),
                                  _Event("cudaLaunchKernel", "CPU", 246, 2),
                                  _Event(ADD, "CUDA", 450, 1)]
    assert spans.launched_within(_stop(both), "vk.refresh") is None


def _sweep_trace():
    """A traced case (s): its build 0-1.2 with the card idle to 1.0, the
    solve 1-5.9 on the card, outputs 6-9.5 (copies 6-6.5, one on the card
    6-6.1; two VTKs 7-8 and 8.5-9), in a stretch of 10 s."""
    host = [("luw.setup.case", 0.0, 1.2), ("luw.setup.flags", 0.1, 0.3),
            ("cudaLaunchKernel", 1.0, 1.0001), ("cudaLaunchKernel", 1.0002, 1.0003),
            ("luw.output", 6.0, 9.5), ("luw.output.copy", 6.0, 6.25),
            ("cudaMemcpyAsync", 6.0, 6.2), ("luw.output.copy", 6.25, 6.5),
            ("luw.output.vtk", 7.0, 8.0), ("luw.output.vtk", 8.5, 9.0)]
    ops = [(KSC, 0, 1.0, 5.0), (KAVG, 0, 5.0, 5.9), ("Memcpy DtoH", 0, 6.0, 6.1)]
    return Trace(window_s=10.0, devices=(0,), device_ops=ops,
                 spans=[("run_case", 1.0, 9.5)], host_ops=host)


def test_sweep_readers_hand_computed():
    run = _run(_sweep_trace(), cell="datagen-2m.sweep", trace_steps=20001)
    read = {n: spec.reader(n).read(run) for n in (
        "case_build_s.sweep", "output_copy_s.sweep", "vtk_write_s.sweep",
        "idle_output_pct.sweep", "idle_setup_pct.sweep", "device_idle_pct.sweep")}
    assert read["case_build_s.sweep"] == pytest.approx(1.2)
    assert read["output_copy_s.sweep"] == pytest.approx(0.5)
    assert read["vtk_write_s.sweep"] == pytest.approx(1.5)
    assert read["idle_output_pct.sweep"] == pytest.approx(34.0)
    assert read["idle_setup_pct.sweep"] == pytest.approx(10.0)
    assert read["device_idle_pct.sweep"] == pytest.approx(50.0)
    assert spans.launched_within(_sweep_trace(), "output") == pytest.approx(0.1)


@pytest.mark.parametrize("name", ["case_build_s.sweep", "output_copy_s.sweep",
                                  "vtk_write_s.sweep", "idle_output_pct.sweep",
                                  "idle_setup_pct.sweep", "vk_device_ms"])
def test_nothing_to_read_is_none(name):
    """None without a trace, and on a trace without the program's spans
    (the parent's program)."""
    reader = spec.reader(name)
    assert reader.read(_run(None, trace_steps=2)) is None
    assert reader.read(_run(_stop(_step_events(False)), trace_steps=2)) is None


def test_tiny_sweep_traced_on_the_cpu(tmp_path):
    """The program's spans reach the readers: a traced run of two tiny
    cases on the CPU (no device: every moment of the stretch is idle)."""
    from latticeurbanwind_tpu_torch.run.modes import run_deck

    from tiny import tiny_cell
    from luwbench.harness import deck_keys, write_deck

    cell = tiny_cell("datagen-2m.sweep")
    deck = write_deck(cell, deck_keys(cell, 2147483801), tmp_path, "case")
    tracer = Tracer(())
    tracer.start()
    results = run_deck(deck, device="cpu", quiet=True, max_cases=2)
    trace = tracer.stop()
    trace.devices = (0,)
    run = _run(trace, cell="datagen-2m.sweep")
    build = spec.reader("case_build_s.sweep").read(run)
    vtk = spec.reader("vtk_write_s.sweep").read(run)
    copy = spec.reader("output_copy_s.sweep").read(run)
    assert 0 < build < trace.window_s and 0 < copy and 0 < vtk
    assert copy + vtk < spans.seconds(trace, "output") < trace.window_s
    assert spec.reader("idle_output_pct.sweep").read(run) == pytest.approx(
        100 * spans.seconds(trace, "output") / trace.window_s)
    assert len([n for n, _, _ in trace.host_ops if n == "luw.output.vtk"]) == \
        sum(f.suffix == ".vtk" for r in results for f in r.files) == 6


@pytest.mark.card
def test_program_span_adds_no_device_operation(card):
    """On the card a `luw.` span leaves the device's operations as they
    are: a user-scope `record_function` is mirrored there, the port's
    spans are not."""
    from latticeurbanwind_tpu_torch.utils.trace import span

    x = torch.randn(4, 32, 32, device="cuda")
    tracer = Tracer([0])
    tracer.start()
    with span("probe"):
        torch.bmm(x, x).add_(1).sum().item()
    trace = tracer.stop()
    assert not [op for op in trace.device_ops if op[0].startswith("luw.")]
    assert [n for n, _, _ in trace.host_ops].count("luw.probe") == 1
    whole = spans.launched_within(trace, "probe")
    assert whole > 0
    # the first record lost, as at a stretch's start: the rest pair
    first = trace.device_ops.pop(0)
    assert spans.launched_within(trace, "probe") == \
        pytest.approx(whole - (first[3] - first[2]))
    # the copy of `.item()` lost too: the last kernel meets the copy's call
    trace.device_ops.remove([op for op in trace.device_ops
                             if op[0].startswith("Memcpy")][-1])
    assert spans.launched_within(trace, "probe") is None
