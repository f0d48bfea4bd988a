"""The program's spans (metrics.span): nothing recorded and no torch call
while recording is off; ids, parents, call ids and self time while a
profiler or `metrics.recording()` is on; the shared clock with the
profiler's events; the benchmark's readers of the spans
(benchmark/harness/spans.py and its four metrics) and the stage table of
tools/stages.py on synthetic records.  `gpu`-marked, on the card: a span
brackets its kernel's CUPTI interval, the sync.* spans match
`torch.cuda.set_sync_debug_mode("warn")`'s warnings one for one on each
cell's path, and the trace.kernel spans' widths are the dispatch's.  No
JAX."""

import json
import os
import sys
import time
import warnings
from types import SimpleNamespace

import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.tools import stages

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import counters, profile, program, registry  # noqa: E402
from harness import spans as bench_spans  # noqa: E402

R = metrics.SpanRecord
CELLS = [w["name"] for w in registry.spec()["workloads"]]


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def fresh():
    metrics.clear_spans()
    yield
    metrics.clear_spans()


def _nested():
    """render.call > (a > (b, c), d), each with a little work."""
    with metrics.call_span("render.call", torch.device("cpu"), integrator="x", frames=2):
        with metrics.span("a", depth=1):
            with metrics.span("b"):
                torch.ones(8).sum()
            time.sleep(0.001)
            with metrics.span("c", width=5):
                pass
        with metrics.span("d"):
            torch.zeros(4)


def test_a_span_off_records_nothing_and_makes_no_torch_call(fresh):
    counter = counters.CallCounter()
    traced = metrics.spanned("e")(lambda: None)
    cpu = torch.device("cpu")
    with counter:
        with metrics.call_span("render.call", cpu, frames=1):
            with metrics.span("a", width=3):
                traced()
    assert counter.calls == 0
    assert metrics.spans() == [] and metrics.current_span() is None


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_nested_spans_parents_calls_and_self_time(fresh, mode):
    if mode == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _nested()
            _nested()
    else:
        with metrics.recording():
            _nested()
            _nested()
    recs = metrics.spans()
    assert [r.name for r in recs] == ["b", "c", "a", "d", "render.call"] * 2
    for first, call in ((0, recs[4].id), (5, recs[9].id)):
        b, c, a, d, root = recs[first:first + 5]
        assert root.parent is None and {a.parent, d.parent} == {root.id}
        assert {b.parent, c.parent} == {a.id}
        assert {r.call for r in (b, c, a, d, root)} == {call} == {root.id}
        assert a.attrs == {"depth": 1} and c.attrs == {"width": 5}
        assert root.attrs["integrator"] == "x" and root.attrs["alloc_before"] == {}
        assert all(r.t0_ns <= r.t1_ns for r in (b, c, a, d, root))
        assert b.t0_ns >= a.t0_ns and c.t1_ns <= a.t1_ns and b.t1_ns <= c.t0_ns
        own = bench_spans.self_ns(recs)
        assert own[a.id] == (a.t1_ns - a.t0_ns) - (b.t1_ns - b.t0_ns) - (c.t1_ns - c.t0_ns)
        assert own[a.id] >= 1_000_000  # the sleep is a's own
        assert own[b.id] == b.t1_ns - b.t0_ns
        assert own[root.id] == (root.t1_ns - root.t0_ns) - (a.t1_ns - a.t0_ns) \
            - (d.t1_ns - d.t0_ns)
    assert metrics.current_span() is None


def test_a_span_brackets_its_op_on_the_profilers_clock(fresh):
    x = torch.ones(256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(50):
            with metrics.span("probe"):
                x * 2
    probes = metrics.spans()
    events = prof.profiler.kineto_results.events()
    muls = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                  if e.name() == "aten::mul")
    ranges = [e for e in events if e.name() == "probe"]
    assert len(probes) == len(muls) == len(ranges) == 50
    for r, (s, e) in zip(probes, muls):
        assert r.t0_ns <= s and e <= r.t1_ns


def _rec(records_k=2, frames=4):
    """A traced run's record with `records_k` device-profiled calls and a
    host-profiled slice starting at t = 100 s."""
    host = profile.Trace(device=[], host=[(100.0, 100.5, "aten::mul")], window_s=1.0)
    dev = profile.Trace(device=[(1.0, 2.0, "k")], host=[], window_s=1.0)
    return SimpleNamespace(trace=dev, host_traces=[host], traced_calls=records_k,
                           trace_frames=frames)


def _synthetic():
    """Three device-slice calls (the first from an earlier traced slice),
    then one host-slice call; times in ns."""
    s = 10 ** 9
    out = []
    for call, t in ((1, 10), (10, 20), (20, 30), (30, 101)):
        base = t * s
        out += [
            R(call + 1, call + 2, call, "trace.kernel", base + 100, base + 300,
              {"n_valid": 300, "n_pad": 512, "bounded": False}),
            R(call + 2, call + 5, call, "pt.bounce", base + 50, base + 1000, {"depth": 0}),
            R(call + 3, call + 5, call, "sync.alive", base + 1000, base + 1400, {}),
            R(call + 4, call + 5, call, "trace.kernel", base + 1500, base + 1600,
              {"n_valid": 100, "n_pad": 512, "bounded": True}),
            R(call + 5, call, call, "pt.env", base + 20, base + 2000, {}),
            R(call, None, call, "render.call", base, base + 3000, {}),
        ]
    return out


def test_harness_takes_the_device_profiled_calls_and_their_self_time(monkeypatch):
    recs = _synthetic()
    rec = _rec()
    picked = bench_spans.device_profiled(rec, recs)
    assert {r.call for r in picked} == {10, 20}  # the last K calls before the host slice
    monkeypatch.setattr(bench_spans, "recorded", lambda: recs)
    read = {m: registry.reader(m)(rec) for m in (
        "integrator.host_ms_per_frame", "tracer.host_ms_per_frame", "host_syncs_per_frame",
        "cluster_kernel.live_lane_share")}
    # per call: pt.bounce 950 - 200 (trace.kernel), pt.env 1980 - 950 - 400 - 100
    assert read["integrator.host_ms_per_frame"] == pytest.approx(2 * (750 + 530) * 1e-6 / 4)
    assert read["tracer.host_ms_per_frame"] == pytest.approx(2 * 300 * 1e-6 / 4)
    assert read["host_syncs_per_frame"] == pytest.approx(2 / 4)
    assert read["cluster_kernel.live_lane_share"] == pytest.approx(400 / 1024)
    # an older program without spans, or a run without a traced slice
    monkeypatch.setattr(bench_spans, "recorded", lambda: None)
    assert all(registry.reader(m)(rec) is None for m in read)
    monkeypatch.setattr(bench_spans, "recorded", lambda: recs)
    assert all(registry.reader(m)(SimpleNamespace(trace=None, trace_frames=0)) is None
               for m in read)


def test_stage_table_puts_the_idle_time_under_the_innermost_span():
    recs = [r for r in _synthetic() if r.call == 10]
    base = 20 * 10 ** 9
    device = [(base + 100, base + 300), (base + 1200, base + 1300)]
    table = stages.stage_table(recs, device, [(base - 500, base + 3000)], frames=1)
    st = table["stages"]
    assert st["trace.kernel"]["host_ms"] == pytest.approx(300e-6)
    assert st["trace.kernel"]["busy_ms"] == pytest.approx(200e-6)
    assert st["sync.alive"]["busy_ms"] == pytest.approx(100e-6)
    assert st["pt.env"]["idle_ms"] == pytest.approx(530e-6)
    assert st["render.call"]["idle_ms"] == pytest.approx(1020e-6)
    idle = 3500 - 300
    assert table["idle_ms"] == pytest.approx(idle * 1e-6)
    assert table["idle_in_stage"] == pytest.approx((idle - 1020 - 500) / idle)
    # leaves: the two trace.kernel spans and sync.alive
    assert table["idle_in_leaf"] == pytest.approx((0 + 300 + 100) / idle)
    assert table["wall_in_root"] == pytest.approx(3000 / 3500)


def test_stages_tool_runs_a_call_on_the_cpu(fresh, capsys):
    """tools/stages.py end to end at 8^2: every path stage in the table,
    the calls of a frame all charged to a stage, no device time on the CPU."""
    stages.main(["cornell_box", "--frames", "2", "--size", "8", "--device", "cpu"])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["device"] == "cpu" and r["frames_per_call"] == 2 and r["calls"] == 1
    assert {"render.call", "pt.camera", "pt.bounce", "pt.shade", "pt.nee", "sync.alive",
            "film.accumulate"} <= set(r["stages"])
    assert "other" not in r["torch_calls_per_frame"]
    assert all(v["busy_ms"] == 0.0 for v in r["stages"].values())
    assert r["idle_in_stage"] > 0.9 and r["wall_in_root"] > 0.9 and r["allocator_per_call"] == {}


# ------------------------------------------------------------------ card


def _cell(name, size=64):
    wl = registry.workload(name)
    wl.update(width=size, height=size)
    return program.setup(registry.config(wl["config"]), wl, torch.device("cuda")), wl


@pytest.mark.gpu
@pytest.mark.parametrize("host", [False, True], ids=["device_only", "with_host_ops"])
def test_a_span_brackets_its_kernels_cupti_interval(cuda, fresh, host):
    """Each probe span holds 1 ms of host time, one GEMM launch, a
    synchronize and 1 ms more; the GEMM's CUPTI interval lies inside it.
    (CUPTI's device times follow the host clock to within ~0.2 ms in every
    session measured, to within a few us in most: the margins cover it.)"""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            with metrics.span("probe"):
                time.sleep(0.001)
                x @ x
                torch.cuda.synchronize()
                time.sleep(0.001)
    probes = metrics.spans()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    assert len(probes) == len(kernels) == 20
    for r, (s, e) in zip(probes, kernels):
        assert r.t0_ns <= s and e <= r.t1_ns, (r.t0_ns, s, e, r.t1_ns)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_sync_spans_are_the_sync_debug_warnings(cuda, fresh, cell):
    prog, wl = _cell(cell)
    n = wl["frames_per_call"]
    prog.call(prog.new_film(5), n)
    torch.cuda.synchronize()
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, *a, **k: seen.append(
            (metrics.current_span(), str(msg)))
        with metrics.recording():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                prog.call(prog.new_film(6), n)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = [r for r in metrics.spans() if r.name.startswith("sync.")]
    found = [span for span, msg in seen if "called a synchronizing CUDA operation" in msg]
    assert found and all(s is not None and s.startswith("sync.") for s in found), found
    assert len(found) == len(syncs)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_trace_kernel_spans_carry_the_dispatch_widths(cuda, fresh, cell):
    prog, wl = _cell(cell)
    n = wl["frames_per_call"]
    prog.call(prog.new_film(5), n)
    with counters.kernel_widths() as widths, metrics.recording():
        prog.call(prog.new_film(6), n)
    launched = [r.attrs for r in metrics.spans() if r.name == "trace.kernel"
                and r.attrs["n_pad"] > 0]
    assert widths and len(launched) == len(widths)
    assert [(a["n_valid"], a["bounded"]) for a in launched] == widths
