"""The Cornell box as a benchmark cell (`cornell_box.pt_nee`), on the CPU and
without JAX:

  * the benchmark's frozen copy builds the port's host dict, its
    configuration file holds the port's ExampleConfig, and one call
    through the harness's program equals the plain reference's replay
    under the reference's per-frame schedule with NEE, also at a width
    whose deep phases sit on their 1,024-lane floor; the bfloat16 control
    departs from it;
  * the spans this cell adds (`pt.shadow` around NEE's shadow trace,
    `live` on the per-frame `pt.flush_compact`) carry their attributes
    while spans record, and off recording the path makes the torch calls
    it made without them;
  * the cell's three readers read None on the CPU's trace where they
    need the card, and on records without the spans, and what the
    launches give on faked ones.
"""

import dataclasses
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.accel import trace
from ti_raytrace_tpu_torch.examples import scenes
from ti_raytrace_tpu_torch.integrators import pt_rgb

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import (cell, compare, counters, nee_sweep, profile, program,  # noqa: E402
                     registry, spans)
from reference import control, render  # noqa: E402
from reference.plain.examples import cornell_box as ref_cornell  # noqa: E402

torch.set_num_threads(2)

CELL = "cornell_box.pt_nee"
READERS = ("nee_sweep.ms_per_frame", "nee_sweep_roofline", "pt_compaction.fill_share")
CPU = torch.device("cpu")


@pytest.fixture
def fresh():
    metrics.clear_spans()
    yield
    metrics.clear_spans()


def _cell(size, frames=None):
    wl = registry.workload(CELL)
    wl.update(width=size, height=size)
    if frames is not None:
        wl["frames_per_call"] = frames
    config = registry.config(wl["config"])
    return wl, config, program.setup(config, wl, CPU)


def test_reference_host_is_the_programs():
    module, name = registry.config("cornell_box")["host"].split(":")
    assert (module, name) == ("cornell_box", "cornell_box_host")
    ref = ref_cornell.cornell_box_host()
    prog = scenes.cornell_box_host()
    assert set(ref) <= set(prog)
    for k, v in ref.items():
        assert np.array_equal(np.asarray(v), np.asarray(prog[k])), k
    assert len(ref["prim_type"]) == 36 and len(ref["vtx_pos"]) == 3 * 36


def test_configuration_is_the_programs_example():
    """The configuration's `example` is scenes.cornell_box's ExampleConfig
    field by field (values and types), and its sizes are the scene's: 36
    prims, two groups of the dense table, NEE taken."""
    config = registry.config("cornell_box")
    got = render.example_config(config)
    scene, want = scenes.example_cached("cornell_box", CPU)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a == b and type(a) is type(b), f.name
    assert (config["prims"], config["triangles"], config["reduced"]) == (36, 36, [])
    assert scene.n_prims == 36 and scene.dense_boxes.shape[0] == 2
    assert pt_rgb.has_nee_materials(scene)
    assert registry.workload(CELL)["frames_per_call"] == want.batch == 32


@pytest.mark.parametrize("size, seed, widths", [
    (32, 3141592653, [1024] * 4),               # every phase at the floor, = N
    (64, 2**31 + 7, [2048, 1024, 1024, 1024]),  # N/8 and N/16 clamped to 1,024
])
def test_program_call_is_the_reference_replay(fresh, size, seed, widths):
    """One 2-frame call through the harness's program equals the plain
    reference's replay of it, film and key, with no path cut; each frame
    compacts at bounces 3, 5, 8 and 11 to the schedule's widths, which
    `_phase_width` holds at its 1,024-lane floor where N/dv is below it."""
    wl, config, prog = _cell(size)
    fl0 = prog.new_film(seed)
    with metrics.recording():
        fl, overflow = prog.call(fl0, 2)
    ref = render.build(config, wl, CPU)
    want, ref_overflow = render.replay(ref, fl0.hdr, fl0.frame, render.key_at(seed, 0), 2)
    assert torch.equal(fl.hdr, want.hdr) and float(fl.hdr.abs().sum()) > 0
    assert compare.film_gap(fl.hdr, want.hdr, 2, 2) == 0.0
    assert torch.equal(fl.key, want.key) and fl.frame == want.frame == 2
    assert overflow == ref_overflow == 0
    phases = [r.attrs for r in metrics.spans() if r.name == "pt.flush_compact"]
    assert [a["width_out"] for a in phases] == widths * 2
    assert all(int(a["live"]) <= a["width_out"] for a in phases)


def test_control_is_not_correct():
    """The reference in bfloat16, in the program's place, fails the
    comparison on this cell (16x16, 1-frame calls)."""
    wl, config, _ = _cell(16, frames=1)
    ctl = control.Control(config, wl, CPU)
    result, _ = cell.run_cell(ctl, wl, config, registry.spec(), 4, math.inf, False, 0.0,
                              max_calls=2)
    assert not result["correct"]
    assert result["checks"]["film_gap"]["value"] > 1.0


def test_new_spans_carry_their_attributes_on_the_cpu(fresh):
    """A recorded 1-frame call at 64x64: a `pt.shadow` of each NEE bounce's
    width, each the parent of one dense sweep of that width (the plain
    route), and the four per-frame `pt.flush_compact` with `live`, the
    live lanes before the compaction as a 0-dim tensor."""
    _, _, prog = _cell(64)
    with metrics.recording():
        prog.call(prog.new_film(5), 1)
    recs = metrics.spans()
    shadow = {r.id: r.attrs for r in recs if r.name == "pt.shadow"}
    bounces = [r.attrs["width"] for r in recs if r.name == "pt.bounce"]
    assert sorted(a["width"] for a in shadow.values()) == sorted(bounces) and len(bounces) > 5
    under = [r for r in recs if r.name == "dense_trace._sweep" and r.parent in shadow]
    assert len(under) == len(shadow)
    assert all(r.attrs["n"] == shadow[r.parent]["width"] for r in under)
    assert all(r.attrs["groups"] == 2 for r in under)
    phases = [r.attrs for r in recs if r.name == "pt.flush_compact"]
    assert len(phases) == 4
    for a in phases:
        assert set(a) == {"width_in", "width_out", "live"}
        assert a["live"].dim() == 0 and 0 < int(a["live"]) <= a["width_in"]


def _compact_without_live(carry, new_n: int, sp=None):
    """pt_rgb._compact as it was before it carried `live`."""
    alive = carry["alive"]
    overflow = torch.clamp(alive.sum() - new_n, min=0)
    order = pt_rgb._stable_order((~alive).to(torch.int64))
    return pt_rgb._permute(carry, order[:new_n]), overflow


def _calls(prog, n):
    fl = prog.new_film(11)
    with counters.CallCounter() as counter:
        fl, _ = prog.call(fl, n)
    return counter.calls, fl


@pytest.mark.parametrize("name, compaction", [
    ("cornell_box", None),                              # the cell's own schedule, NEE
    ("single_model", scenes.BENCH_SCHEDULE_MERGED),     # bench_100k's preview: 1 frame, no NEE
])
def test_off_recording_the_spans_make_no_torch_call(monkeypatch, name, compaction):
    """Off recording, a call makes as many torch calls as with NEE's
    shadow trace inline and `_compact` without `live`, and renders the
    same film: on a cornell call, and on a 1-frame call of the per-frame
    path under bench_100k's schedule."""
    assert not metrics.recording_now()
    wl = registry.workload(CELL)
    wl.update(width=32, height=32, frames_per_call=1)
    config = registry.config(name)
    prog = program.setup(config, wl, CPU)
    if compaction is not None:
        prog.cfg = dataclasses.replace(prog.cfg, compaction=compaction, group=None)
    calls, fl = _calls(prog, 1)
    with monkeypatch.context() as mp:
        mp.setattr(pt_rgb, "_compact", _compact_without_live)
        mp.setattr(pt_rgb, "_shadow_trace",
                   lambda scene, o, d: trace(scene, o, d, sort_small=True)[1])
        before, fl_before = _calls(prog, 1)
    assert calls == before > 0 and torch.equal(fl.hdr, fl_before.hdr)


def _traced_cpu_run(monkeypatch):
    """A traced run of the cell at 64x64 on the CPU, 1-frame calls: its
    result and its record, with the program's spans."""
    wl, config, prog = _cell(64, frames=1)
    records = []
    real = cell.window

    def window(*args, **kw):
        records.append(real(*args, **kw))
        return records[-1]

    monkeypatch.setattr(cell, "window", window)
    result, _ = cell.run_cell(prog, wl, config, registry.spec(), 2**31 + 5, math.inf, True,
                              0.0, max_calls=4)
    return result, records[0]


def test_readers_on_a_recorded_cpu_trace(fresh, monkeypatch):
    """A traced CPU run reads neither kernel metric (no kernel event) and
    raises nothing; the fill share reads the live lanes over the kept
    ones, at most 1.  On its own spans with a kernel event after each
    sweep that launched, the kernel metrics read NEE's sweeps alone, also
    where the profile lost a stretch of events; without the spans, or
    with more events than launches, None."""
    result, rec = _traced_cpu_run(monkeypatch)
    assert result["correct"] and result["failed"] == 0
    assert set(READERS) & set(result["metrics"]) == {"pt_compaction.fill_share"}
    picked = spans.device_profiled(rec)
    phases = [r.attrs for r in picked if r.name == "pt.flush_compact"]
    fill = result["metrics"]["pt_compaction.fill_share"]["value"]
    assert fill == pytest.approx(sum(int(a["live"]) for a in phases)
                                 / sum(a["width_out"] for a in phases))
    assert 0 < fill <= 1
    sweeps = [r for r in picked if r.name == "dense_trace._sweep"]
    shadow = {r.id for r in picked if r.name == "pt.shadow"}
    nee = [r.attrs for r in sweeps if r.parent in shadow]
    assert nee and len(nee) < len(sweeps)
    # one kernel event a launch, 30 us after it: 1 ms under pt.shadow, 2 ms elsewhere;
    # on the epoch's clock in seconds, as the profile has them, to ~0.2 us (rel=1e-3)
    events = [(r.t0_ns * 1e-9 + 3e-5, r.t0_ns * 1e-9 + 3e-5 + (1e-3 if r.parent in shadow
                                                                else 2e-3),
               "dense_sweep_kernel(float const*, ...)") for r in sweeps]
    events.append((events[0][0] + 1e-5, events[0][0] + 2e-5, "elementwise_kernel"))
    peak = {"bytes_per_s": 1e12}
    fake = SimpleNamespace(trace=profile.Trace(events, [], 1.0), trace_frames=rec.trace_frames,
                           peak=peak, traced_calls=1, host_traces=[])
    lanes = sum(a["n"] for a in nee)
    with monkeypatch.context() as mp:
        mp.setattr(spans, "recorded", lambda: picked)
        got = {m: registry.reader(m)(fake) for m in READERS}
        assert got["nee_sweep.ms_per_frame"] == pytest.approx(
            len(nee) * 1e-3 / rec.trace_frames * 1e3, rel=1e-3)
        assert got["nee_sweep_roofline"] == pytest.approx(
            100 * sum(32 * n / 1e12 for n in (a["n"] for a in nee)) / (len(nee) * 1e-3), rel=1e-3)
        assert got["pt_compaction.fill_share"] == pytest.approx(fill)
        # the profile lost the events of launches 3-6: the rest keep their own
        kept = [r for i, r in enumerate(sweeps) if not 3 <= i <= 6]
        kept_nee = [r.attrs for r in kept if r.parent in shadow]
        fake.trace = profile.Trace(events[:3] + events[7:], [], 1.0)
        assert len(kept_nee) < len(nee)
        assert registry.reader("nee_sweep.ms_per_frame")(fake) == pytest.approx(
            len(kept_nee) * 1e-3 * lanes / sum(a["n"] for a in kept_nee)
            / rec.trace_frames * 1e3, rel=1e-3)
        assert registry.reader("nee_sweep_roofline")(fake) == pytest.approx(
            100 * sum(32 * a["n"] / 1e12 for a in kept_nee) / (len(kept_nee) * 1e-3), rel=1e-3)
        # more kernel events than launches read nothing
        fake.trace = profile.Trace(events + events[:1], [], 1.0)
        assert registry.reader("nee_sweep.ms_per_frame")(fake) is None
        assert registry.reader("nee_sweep_roofline")(fake) is None
        fake.trace = profile.Trace(events, [], 1.0)
        # a program without the spans (the parent's): no pt.shadow, no live
        older = [r._replace(attrs={k: v for k, v in r.attrs.items() if k != "live"})
                 for r in picked if r.name != "pt.shadow"]
        mp.setattr(spans, "recorded", lambda: older)
        assert all(registry.reader(m)(fake) is None for m in READERS)
    assert all(registry.reader(m)(SimpleNamespace(trace=None, peak=peak)) is None
               for m in READERS)


@pytest.mark.parametrize("lost", [(), (0, 1), (4, 5, 6), (7,), (2, 3, 9, 10, 11), (13, 14)])
def test_pairing_skips_the_launches_whose_events_were_lost(lost):
    """`nee_sweep.pair` gives each event to its own launch where stretches
    of events are missing at the start, in the middle or at the end: on a
    device clock that stands 1.2 s behind the host's and runs 0.8% slow
    (as far as the card's clock was seen to drift in a profiled call),
    with launch gaps of 0.3-1.9 ms and the kernels' lags from their
    launches jittered by up to 0.15 ms."""
    gaps = [3e-4, 1.9e-3, 6e-4, 1.1e-3, 3e-4, 8e-4, 1.4e-3, 3e-4, 5e-4, 1.7e-3, 4e-4, 9e-4,
            3e-4, 1.2e-3]
    t = [1.7e9 + sum(gaps[:i]) for i in range(len(gaps) + 1)]
    launches = [SimpleNamespace(t0_ns=round(x * 1e9), i=i) for i, x in enumerate(t)]
    lag = [5e-5 + (i * 7 % 4) * 5e-5 for i in range(len(t))]
    start = [t[0] - 1.2 + 0.992 * (x - t[0]) + dt for x, dt in zip(t, lag)]
    events = [(start[i], start[i] + 1e-4 * (1 + i % 3)) for i in range(len(t)) if i not in lost]
    paired = nee_sweep.pair(launches, events)
    assert [r.i for r, _ in paired] == [i for i in range(len(t)) if i not in lost]
    # seconds on the epoch's clock, as the profile has them, to ~0.2 us
    assert all(secs == pytest.approx(1e-4 * (1 + r.i % 3), abs=1e-6) for r, secs in paired)
    assert nee_sweep.pair(launches[:3], events) is None
