"""The single_model configuration on the CPU: the frozen copy's host dict
and dense tracer against the port's, the bfloat16 control on its cell,
and the three readers of the dense kernel (`dense_kernel.ms_per_frame`,
`dense_kernel_roofline`, `dense_kernel.culled_share`) on a recorded
trace, and None on a program whose spans carry no attributes.
`gpu`-marked: the three read on the card from a traced run of the cell."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import cell, dense_work, profile, program, registry, spans
from reference import control, render
from reference.plain.examples import single_model as ref_single_model
from reference.plain.ops import dense_trace as ref_dt

CELL = "single_model.batch"
READERS = ("dense_kernel.ms_per_frame", "dense_kernel_roofline", "dense_kernel.culled_share")


def _cell(size, device="cpu"):
    wl = registry.workload(CELL)
    wl.update(width=size, height=size)
    config = registry.config(wl["config"])
    return wl, config, program.setup(config, wl, torch.device(device))


def test_reference_host_is_the_programs():
    from ti_raytrace_tpu_torch.examples import scenes

    module, name = registry.config("single_model")["host"].split(":")
    assert (module, name) == ("single_model", "single_model_host")
    ref = ref_single_model.single_model_host()
    prog = scenes.single_model_host()
    assert set(ref) <= set(prog)
    for k, v in ref.items():
        assert np.array_equal(np.asarray(v), np.asarray(prog[k])), k


def test_plain_dense_tracer_is_the_ports():
    """The copy's trace_shaded (and its capped sweep) give the port's CPU
    tracer's bits on 600 seeded rays, a quarter aimed at the sphere."""
    from ti_raytrace_tpu_torch.ops import dense_trace as port_dt

    wl, cfg, prog = _cell(8)
    ref = render.build(cfg, wl, "cpu")
    assert ref.scene.n_prims == prog.scene.n_prims == 2281
    g = torch.Generator().manual_seed(17)
    lo, hi = prog.scene.aabb_min, prog.scene.aabb_max
    o = lo[:, None] + (hi - lo)[:, None] * (torch.rand(3, 600, generator=g) * 1.4 - 0.2)
    d = torch.randn(3, 600, generator=g)
    d[:, :150] = (0.5 * (lo + hi))[:, None] - o[:, :150]
    o, d = o.contiguous(), (d / d.norm(dim=0, keepdim=True)).contiguous()
    a = port_dt.trace_shaded(prog.scene, o, d)
    b = ref_dt.trace_shaded(ref.scene, o, d)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int((a[1] >= 0).sum()) > 150
    active = torch.rand(600, generator=g) < 0.3
    a = port_dt.trace_planar_capped(prog.scene, o, d, active, 0.5)
    b = ref_dt.trace_planar_capped(ref.scene, o, d, active, 0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_control_is_not_correct():
    """The reference in bfloat16, in the program's place, fails the
    comparison on this cell too (at 16x16, 1-frame calls; the kept call
    is of a later frame than 0, whose camera jitter is off: glass draws
    its uniforms only for Fresnel and roulette choices, which bfloat16
    rarely flips in 256 paths, while a cell's 16-frame call always holds
    jittered frames)."""
    wl, cfg, _ = _cell(16)
    wl["frames_per_call"] = 1
    ctl = control.Control(cfg, wl, torch.device("cpu"))
    result, _ = cell.run_cell(ctl, wl, cfg, registry.spec(), 4, math.inf, False, 0.0,
                              max_calls=3)
    assert not result["correct"]
    assert result["checks"]["film_gap"]["value"] > 1.0


def _traced_cpu_run(monkeypatch):
    """A traced run of the cell at 16x16 on the CPU (one merged group a
    call): its result and its record, with the program's spans."""
    wl, cfg, prog = _cell(16)
    records = []
    real = cell.window

    def window(*args, **kw):
        records.append(real(*args, **kw))
        return records[-1]

    monkeypatch.setattr(cell, "window", window)
    result, _ = cell.run_cell(prog, wl, cfg, registry.spec(), 2**31 + 5, math.inf, True, 0.0,
                              max_calls=4)
    return result, records[0]


def test_readers_on_a_recorded_cpu_trace(monkeypatch):
    """A traced CPU run reads none of the three (no kernel ran, so no kernel
    event and no counts) and raises nothing.  On its own spans, with a
    kernel event put beside each sweep that launched and counts put on its
    span, they read what the launches' widths and counts give; on the
    same spans without their attributes (an older program), the roofline
    and the culled share read None."""
    from ti_raytrace_tpu_torch import metrics

    metrics.clear_spans()
    result, rec = _traced_cpu_run(monkeypatch)
    assert result["correct"] and not set(READERS) & set(result["metrics"])
    picked = spans.device_profiled(rec)
    sweeps = [r for r in picked if r.name == "dense_trace._sweep"]
    assert sweeps and all({"n", "groups", "tail"} <= set(r.attrs) for r in sweeps)
    launched = [r for r in sweeps if r.attrs["n"] > 0]
    # one 1 ms kernel event per launch, and counts: a tenth of the pairs tested
    events = [(i * 1e-2, i * 1e-2 + 1e-3, "dense_sweep_kernel(float const*, ...)")
              for i in range(len(launched))] + [(0.5, 0.6, "elementwise_kernel")]
    pairs = [dense_work.warp_group_pairs(r.attrs["n"], r.attrs["groups"]) for r in sweeps]
    tested = [p // 10 for p in pairs]
    faked = [r._replace(attrs=dict(r.attrs, counts=torch.tensor([t, 0, 0, 0, 0],
                                                                dtype=torch.int32)))
             for r, t in zip(sweeps, tested)]
    others = [r for r in picked if r.name != "dense_trace._sweep"]
    trace = profile.Trace(events, [], 1.0)
    peak = {"bytes_per_s": 1e12}
    fake = SimpleNamespace(trace=trace, trace_frames=rec.trace_frames, peak=peak,
                           traced_calls=1, host_traces=[])
    with monkeypatch.context() as mp:
        mp.setattr(spans, "recorded", lambda: others + faked)
        got = {m: registry.reader(m)(fake) for m in READERS}
        least = sum(32 * r.attrs["n"] / 1e12 for r in launched)
        assert got["dense_kernel.ms_per_frame"] == pytest.approx(
            len(launched) * 1e-3 / rec.trace_frames * 1e3)
        assert got["dense_kernel_roofline"] == pytest.approx(
            100 * least / (len(launched) * 1e-3))
        assert got["dense_kernel.culled_share"] == pytest.approx(1 - sum(tested) / sum(pairs))
        # launches and kernel events that differ in number read nothing
        fake.trace = profile.Trace(events[1:], [], 1.0)
        assert registry.reader("dense_kernel_roofline")(fake) is None
        fake.trace = trace
        # spans without attributes (a program older than them)
        mp.setattr(spans, "recorded", lambda: others + [r._replace(attrs={}) for r in sweeps])
        assert registry.reader("dense_kernel_roofline")(fake) is None
        assert registry.reader("dense_kernel.culled_share")(fake) is None
        assert registry.reader("dense_kernel.ms_per_frame")(fake) is not None
        # no trace at all
        assert all(registry.reader(m)(SimpleNamespace(trace=None, peak=peak)) is None
                   for m in READERS)
    metrics.clear_spans()


def test_least_bytes_and_pairs_of_a_dense_launch():
    assert dense_work.launch_bytes(0) == 0
    assert dense_work.launch_bytes(3) == 3 * (24 + 8)
    assert dense_work.warp_group_pairs(1, 72) == 8 * 72
    assert dense_work.warp_group_pairs(512 * 512, 72) == 1024 * 8 * 72
    assert dense_work.warp_group_pairs(257, 2) == 2 * 8 * 2


@pytest.mark.gpu
def test_dense_metrics_read_on_the_card():
    """A traced run of the cell at 64x64 on the card: correct, and the
    three metrics read, each in its range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl, cfg, prog = _cell(64, "cuda")
    cell.warm_up(prog, wl, 1)
    result, _ = cell.run_cell(prog, wl, cfg, registry.spec(), 2**31 + 11, math.inf, True, 0.0,
                              max_calls=4)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["dense_kernel.ms_per_frame"] > 0
    assert 0 < m["dense_kernel_roofline"] <= 100
    assert 0 <= m["dense_kernel.culled_share"] <= 1
