"""The prism dispersion demo as a benchmark cell (`prism_rainbow.bdpt_spec`),
on the CPU and without JAX:

  * `examples/run.render_batch` renders the spectral integrators without
    a spectral context from its caller, bit-equal to passing one, and
    builds the context once per setting and device;
  * the benchmark's frozen copy builds the port's host dict, its
    configuration file holds the port's ExampleConfig, and one call
    through the harness's program equals the plain reference's replay,
    with the walk fronts and the shadow batch cut by the reference's
    schedule; the bfloat16 control departs from it;
  * the spans this cell adds (`bdpt.spec_ctx`, `bdpt.camera`,
    `bdpt.compact_walk`, `n_active` on the capped sweep, the film and
    overflow spans of `bdpt_spec.render_film_frames`) carry their
    attributes, and the cell's five readers read None on the CPU and on
    records without them, and what the launches give on faked ones.
"""

import dataclasses
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch import film, metrics
from ti_raytrace_tpu_torch.examples import run, scenes
from ti_raytrace_tpu_torch.ops import dense_trace as dt

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import cell, dense_work, profile, program, registry, spans  # noqa: E402
from reference import control, render  # noqa: E402
from reference.plain.examples import prism_rainbow as ref_prism  # noqa: E402

torch.set_num_threads(2)

CELL = "prism_rainbow.bdpt_spec"
READERS = ("shadow_sweep.ms_per_frame", "shadow_sweep_roofline", "shadow_sweep.culled_share",
           "shadow_cap.fill_share", "walk_compaction.fill_share")
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


@pytest.mark.parametrize("name, integrator", [("prism_rainbow", "bdpt_spec"),
                                              ("spectral_box", "pt_spec")])
def test_render_batch_builds_the_spectral_context_once(monkeypatch, name, integrator):
    """Without `sdata`, render_batch renders the film's bits of the call
    given `spectral_data(...)`, builds the context once for two calls and
    for an equal config of another identity, and again for another
    setting."""
    scene, cfg = scenes.example_cached(name, CPU)
    spec, cam = scenes.make_camera(scene, cfg, 16, 16)
    given = run.render_batch(scene, cfg, spec, cam, film.new_film(16, 16, seed=9, device=CPU),
                             1, integrator, sdata=run.spectral_data(cfg, integrator, CPU))[0]
    built = []
    real = run.spectral_data
    monkeypatch.setattr(run, "_SPECTRAL", {})
    monkeypatch.setattr(run, "spectral_data", lambda *a: built.append(a) or real(*a))
    fl = film.new_film(16, 16, seed=9, device=CPU)
    fl, _ = run.render_batch(scene, cfg, spec, cam, fl, 1, integrator)
    assert torch.equal(fl.hdr, given.hdr) and float(fl.hdr.abs().sum()) > 0
    run.render_batch(scene, cfg, spec, cam, fl, 1, integrator)
    run.render_batch(scene, dataclasses.replace(cfg), spec, cam, fl, 1, integrator)
    assert len(built) == 1
    other = dataclasses.replace(cfg, sky=dict(cfg.sky, emitter_scale=2.0))
    run.render_batch(scene, other, spec, cam, fl, 1, integrator)
    assert len(built) == 2 and built[1][0] is other


def test_reference_host_is_the_programs():
    module, name = registry.config("prism_rainbow")["host"].split(":")
    assert (module, name) == ("prism_rainbow", "prism_rainbow_host")
    ref = ref_prism.prism_rainbow_host()
    prog = scenes.prism_rainbow_host()
    assert set(ref) <= set(prog)
    for k, v in ref.items():
        assert np.array_equal(np.asarray(v), np.asarray(prog[k])), k
    assert len(ref["prim_type"]) == 3154 and len(ref["vtx_pos"]) == 3 * 3152


def test_configuration_is_the_programs_example():
    """The configuration's `example` is scenes.prism_rainbow's
    ExampleConfig field by field (values and types), and its sizes are
    the scene's."""
    config = registry.config("prism_rainbow")
    got = render.example_config(config)
    _, want = scenes.example_cached("prism_rainbow", CPU)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a == b and type(a) is type(b), f.name
    assert config["example"]["sky"]["emitter_scale"] == float(np.sqrt(3.0))
    assert (config["prims"], config["triangles"], config["reduced"]) == (3154, 3152, [])


@pytest.mark.parametrize("seed", [3141592653, 2**31 + 7])
def test_program_call_is_the_reference_replay(fresh, seed):
    """One 2-frame call at 16^2 through the harness's program equals the
    plain reference's replay of it, film and key; its walk fronts shrink
    at the schedule's depths and the shadow batch is swept at its cap."""
    wl, config, prog = _cell(16)
    fl0 = prog.new_film(seed)
    with metrics.recording():
        fl, overflow = prog.call(fl0, 2)
    ref = render.build(config, wl, CPU)
    want, ref_overflow = render.replay(ref, fl0.hdr, fl0.frame, render.key_at(seed, 0), 2)
    assert torch.equal(fl.hdr, want.hdr) and float(fl.hdr.abs().sum()) > 0
    assert torch.equal(fl.key, want.key) and fl.frame == want.frame == 2
    assert overflow == ref_overflow == 0
    recs = metrics.spans()
    fronts = [r.attrs for r in recs if r.name == "bdpt.compact_walk"]
    assert len(fronts) == 12  # two frames, eye and light at depths 2-4
    assert any(a["capacity"] < a["width_in"] for a in fronts)
    capped = [r.attrs for r in recs if r.name == "dense_trace._sweep" and r.attrs.get("capped")]
    assert len(capped) == 2 and all(a["n"] < a["n_uncapped"] for a in capped)


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
    """A recorded 1-frame call: one `bdpt.spec_ctx` of the film's width,
    one `bdpt.camera`, six `bdpt.compact_walk` with side, depth, width_in
    and capacity (no `live` off the card), the capped sweep with its
    widths (no `n_active` off the card), and bdpt_spec's film and
    overflow spans."""
    wl, _, prog = _cell(16)
    with metrics.recording():
        prog.call(prog.new_film(5), 1)
    recs = metrics.spans()
    names = [r.name for r in recs]
    assert [r.attrs for r in recs if r.name == "bdpt.spec_ctx"] == [{"width": 256}]
    assert names.count("bdpt.camera") == 1
    assert names.count("film.accumulate") == names.count("sync.overflow") == 1
    fronts = [r.attrs for r in recs if r.name == "bdpt.compact_walk"]
    assert [(a["side"], a["depth"]) for a in fronts] == [
        (s, d) for d in (2, 3, 4) for s in ("eye", "light")]
    assert all(set(a) == {"side", "depth", "width_in", "capacity"} for a in fronts)
    (capped,) = [r.attrs for r in recs if r.name == "dense_trace._sweep" and r.attrs.get("capped")]
    assert capped["n"] == dt.capacity_lanes(capped["n_uncapped"], 0.09)
    assert "n_active" not in capped and "counts" not in capped


def _traced_cpu_run(monkeypatch):
    """A traced run of the cell at 16x16 on the CPU, 1-frame calls: its
    result and its record, with the program's spans."""
    wl, config, prog = _cell(16, frames=1)
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
    """A traced CPU run reads none of the five (no kernel event, no device
    counters) and raises nothing.  On its own spans with a kernel event
    beside each sweep that launched and the card's attributes faked on,
    they read what the launches give; without those attributes (an older
    program) or without the spans, None."""
    result, rec = _traced_cpu_run(monkeypatch)
    assert result["correct"] and not set(READERS) & set(result["metrics"])
    picked = spans.device_profiled(rec)
    sweeps = [r for r in picked if r.name == "dense_trace._sweep"]
    fronts = [r for r in picked if r.name == "bdpt.compact_walk"]
    assert fronts and sum(1 for r in sweeps if r.attrs.get("capped")) == 1
    # one 1 ms kernel event per launch; a tenth of each sweep's pairs
    # tested, a twentieth of each capped batch active, half of each front live
    events = [(i * 1e-2, i * 1e-2 + 1e-3, "dense_sweep_kernel(float const*, ...)")
              for i in range(len(sweeps))] + [(0.5, 0.6, "elementwise_kernel")]
    pairs = {r.id: dense_work.warp_group_pairs(r.attrs["n"], r.attrs["groups"]) for r in sweeps}

    def card(r):
        if r.name == "dense_trace._sweep":
            extra = dict(counts=torch.tensor([pairs[r.id] // 10, 0, 0, 0, 0], dtype=torch.int32))
            if r.attrs.get("capped"):
                extra["n_active"] = torch.tensor(r.attrs["n_uncapped"] // 20)
            return r._replace(attrs=dict(r.attrs, **extra))
        if r.name == "bdpt.compact_walk":
            return r._replace(attrs=dict(r.attrs, live=torch.tensor(r.attrs["capacity"] // 2)))
        return r

    faked = [card(r) for r in picked]
    capped = [r.attrs for r in sweeps if r.attrs.get("capped")]
    peak = {"bytes_per_s": 1e12}
    fake = SimpleNamespace(trace=profile.Trace(events, [], 1.0), trace_frames=rec.trace_frames,
                           peak=peak, traced_calls=1, host_traces=[])
    with monkeypatch.context() as mp:
        mp.setattr(spans, "recorded", lambda: faked)
        got = {m: registry.reader(m)(fake) for m in READERS}
        assert got["shadow_sweep.ms_per_frame"] == pytest.approx(
            len(capped) * 1e-3 / rec.trace_frames * 1e3)
        assert got["shadow_sweep_roofline"] == pytest.approx(
            100 * sum(32 * a["n"] / 1e12 for a in capped) / (len(capped) * 1e-3))
        capped_pairs = [dense_work.warp_group_pairs(a["n"], a["groups"]) for a in capped]
        assert got["shadow_sweep.culled_share"] == pytest.approx(
            1 - sum(p // 10 for p in capped_pairs) / sum(capped_pairs))
        assert got["shadow_cap.fill_share"] == pytest.approx(
            sum(a["n_uncapped"] // 20 for a in capped) / sum(a["n"] for a in capped))
        capacity = [r.attrs["capacity"] for r in fronts]
        assert got["walk_compaction.fill_share"] == pytest.approx(
            sum(c // 2 for c in capacity) / sum(capacity))
        # launches and kernel events that differ in number read nothing
        fake.trace = profile.Trace(events[1:], [], 1.0)
        assert registry.reader("shadow_sweep.ms_per_frame")(fake) is None
        assert registry.reader("shadow_sweep_roofline")(fake) is None
        fake.trace = profile.Trace(events, [], 1.0)
        # the spans without the card's attributes, and without the spans
        mp.setattr(spans, "recorded", lambda: picked)
        assert all(registry.reader(m)(fake) is None for m in READERS[2:])
        mp.setattr(spans, "recorded", lambda: [r for r in picked if r.name not in (
            "dense_trace._sweep", "bdpt.compact_walk")])
        assert all(registry.reader(m)(fake) is None for m in READERS)
    assert all(registry.reader(m)(SimpleNamespace(trace=None, peak=peak)) is None
               for m in READERS)
