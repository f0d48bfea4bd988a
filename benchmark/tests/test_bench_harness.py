"""The harness on the CPU: cells, configurations and metrics found by name
(one of each added as files only), the yardstick's arithmetic, the least
work of a kernel launch, and the import rule (no JAX, no JAX package)."""

import json
import math
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from harness import cell, compare, profile, program, registry, stats, work

BENCH = registry.BENCH_DIR
ROOT = registry.ROOT


def test_every_cell_loads_by_name():
    bench = registry.spec()
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert registry.config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] and wl["limits"]["film_gap"] >= 0
        for kind in ("end_to_end", "per_layer"):
            metrics = registry.cell_metrics(bench, w["name"], kind)
            assert metrics
            for m in metrics:
                assert callable(registry.reader(m["name"]))
        names = {m["name"] for m in registry.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in names and len(names) >= 2


def test_a_cell_config_and_metric_added_as_files_only(tmp_path):
    """A new configuration, workload and per-layer metric are new files and
    new BENCHMARK.json entries: the harness runs the new cell from a copy
    of the folder without an edit to any file that was there."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((copy / "configs" / "veach.json").read_text())
    (copy / "configs" / "veach_small.json").write_text(json.dumps(cfg))
    wl = json.loads((copy / "workloads" / "veach.pt_nee.json").read_text())
    wl.update(config="veach_small", width=8, height=8, frames_per_call=1)
    (copy / "workloads" / "veach_small.nee.json").write_text(json.dumps(wl))
    (copy / "metrics" / "frames_counted.py").write_text(
        '"""frames_counted: frames in the window."""\n\n\ndef read(rec):\n'
        '    return float(rec.frames)\n')
    bench = registry.spec()
    bench["configs"].append({"name": "veach_small", "source": cfg["source"],
                             "file": "benchmark/configs/veach_small.json", "reduced": [],
                             "why": "8x8"})
    bench["workloads"].append({"name": "veach_small.nee", "config": "veach_small",
                               "traffic": "nee", "chips": 1, "why": "8x8"})
    bench["end_to_end"].append({"name": "frames_counted", "unit": "frames", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["veach_small.nee"]})
    wl = registry.workload("veach_small.nee", str(copy))
    config = registry.config(wl["config"], str(copy))
    prog = program.setup(config, wl, torch.device("cpu"))
    cell.warm_up(prog, wl, 5)
    result, _ = cell.run_cell(prog, wl, config, bench, 5, math.inf, False, 1.0, max_calls=2,
                              bench_dir=str(copy))
    assert result["correct"] and result["attempted"] == 2
    assert result["metrics"]["frames_counted"]["value"] == 2.0
    assert set(result["metrics"]) == {"ms_per_frame", "setup_s", "frames_counted"}
    assert list(result)[-1] == "checks"


def test_percentile_takes_every_sample():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    rec = SimpleNamespace(workload={"readback": True}, intervals=[0.01] * 95 + [0.1] * 5)
    p95 = registry.reader("update_p95_ms")(rec)
    assert 10.0 < p95 < 100.0
    assert registry.reader("update_p95_ms")(SimpleNamespace(workload={}, intervals=[1.0])) is None


def test_whole_window_rate():
    rec = SimpleNamespace(window_s=2.0, frames=100)
    assert registry.reader("ms_per_frame")(rec) == pytest.approx(20.0)
    assert registry.reader("ms_per_frame")(SimpleNamespace(window_s=1.0, frames=0)) is None


def test_idle_share_from_intervals():
    assert stats.union_length([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert stats.gaps([(0, 1), (2, 3)], 0.0, 4.0) == [(1, 2), (3, 4.0)]
    tr = profile.Trace(device=[(0.0, 1.0, "k1"), (2.0, 3.0, "cluster_trace_kernel<256>"),
                               (2.5, 3.5, "k1")],
                       host=[(0.9, 2.1, "aten::sort"), (3.8, 3.9, "aten::add")], window_s=5.0)
    # two profiled calls of 5 s in all; the window's untraced calls take 4 s each
    rec = SimpleNamespace(trace=tr, trace_frames=4, traced_calls=2, untraced_call_s=4.0)
    assert registry.reader("device_idle_share")(rec) == pytest.approx(1 - 2.5 / 8.0)
    assert registry.reader("device_ms_per_frame")(rec) == pytest.approx(2.5 / 4 * 1e3)
    assert registry.reader("cluster_kernel.ms_per_frame")(rec) == pytest.approx(0.25 * 1e3)
    assert tr.device_ops()[0] == ["k1", pytest.approx(2.0)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::sort"] == pytest.approx(1.0)
    assert gaps["python before aten::add"] == pytest.approx(0.4)
    assert registry.reader("device_idle_share")(SimpleNamespace(trace=None)) is None
    assert registry.reader("device_idle_share")(
        SimpleNamespace(trace=tr, traced_calls=2, untraced_call_s=None)) is None


def test_roofline_share_and_counts():
    peak = {"bytes_per_s": 1e9}
    tr = profile.Trace(device=[(0.0, 0.004, "cluster_trace_kernel<256>"), (0.004, 0.005, "k1"),
                               (0.01, 0.012, "cluster_trace_kernel<256>")],
                       host=[], window_s=0.02)
    # 1e4 unbounded rays (40 B each) and 1e4 bounded ones (44 B each) over
    # 6 ms of the two launches' device time
    rec = SimpleNamespace(trace=tr, launches=[(10_000, False), (10_000, True)], peak=peak)
    read = registry.reader("cluster_kernel_roofline")
    assert read(rec) == pytest.approx(100 * (0.4e-3 + 0.44e-3) / 6e-3)
    # launches that are not the traced kernels' read nothing
    assert read(SimpleNamespace(trace=tr, launches=[(10, False)], peak=peak)) is None
    assert read(SimpleNamespace(trace=tr, launches=[], peak=peak)) is None
    assert read(SimpleNamespace(trace=tr, launches=rec.launches, peak=None)) is None
    assert registry.reader("torch_calls_per_frame")(
        SimpleNamespace(torch_calls=300, counted_frames=4)) == 75.0
    assert registry.reader("preview.readback_ms")(
        SimpleNamespace(readback_s=[0.001, 0.003, 0.002], untraced_calls=None)) == \
        pytest.approx(2.0)
    # the traced updates' spans are left out
    assert registry.reader("preview.readback_ms")(
        SimpleNamespace(readback_s=[0.001, 0.003, 0.009, 0.009], untraced_calls=2)) == \
        pytest.approx(2.0)


class _Fake:
    """A program whose call adds to a film and sleeps a little."""

    device = torch.device("cpu")

    def new_film(self, seed):
        return torch.zeros(4)

    def call(self, fl, n):
        time.sleep(0.01)
        return fl + n, False


def test_traced_slice_follows_the_untraced_calls():
    """A traced run renders untraced calls for the window's seconds, then K
    device-profiled calls, one counted call and K host-profiled calls."""
    wl = {"frames_per_call": 2, "trace_calls": 3}
    rec = cell.window(_Fake(), 1, 0.2, wl, True, compare.Sampler(1))
    assert rec.untraced_calls >= 10
    assert rec.calls == len(rec.intervals) == rec.untraced_calls + 7
    assert rec.trace_frames == 6 and rec.counted_frames == 2 and rec.torch_calls >= 1
    assert len(rec.traces) == 1 and len(rec.host_traces) == 1
    assert sum(rec.intervals[:rec.untraced_calls]) >= 0.2
    untraced = cell.window(_Fake(), 1, 0.2, wl, False, compare.Sampler(1))
    assert untraced.untraced_calls is None and untraced.torch_calls is None


def test_film_gap_undoes_the_dilution():
    x = torch.full((4, 4, 3), 0.5)
    assert compare.film_gap(x, x, 32, 16) == 0.0
    y = x.clone()
    y[1, 2, 0] *= 1.01
    assert compare.film_gap(y, x, 32, 16) == pytest.approx(0.02, rel=1e-4)
    assert compare.film_gap(y, x, 320, 16) == pytest.approx(0.2, rel=1e-4)
    z = x.clone()
    z[0, 0, 0] = float("nan")
    assert not compare.passed({"film_gap": (compare.film_gap(z, x, 32, 16), 1e-3)})


def test_sampler_is_uniform_and_seeded():
    def kept(seed, n):
        s = compare.Sampler(seed)
        for i in range(n):
            s.offer(i, i + 1, 1)
        return s.kept[0]

    assert kept(7, 50) == kept(7, 50)
    picks = [kept(seed, 10) for seed in range(2000)]
    counts = [picks.count(i) for i in range(10)]
    assert min(counts) > 120 and max(counts) < 290


def test_least_work_of_a_launch():
    """The bound counts each live ray's inputs and outputs once, and nothing
    that a traversal could skip."""
    assert work.launch_bytes(0, True) == 0
    assert work.launch_bytes(2, False) == 2 * (24 + 16)
    assert work.launch_bytes(2, True) == 2 * (24 + 4 + 16)
    assert work.bound_s(3.35e12, {"bytes_per_s": 3.35e12}) == pytest.approx(1.0)


def test_kernel_widths_come_from_the_dispatch():
    """The widths are read from the tracer's dispatch as the integrators
    call it (on the CPU its plain path), one per dispatch, and the
    dispatch is restored afterwards."""
    from ti_raytrace_tpu_torch.ops import cluster_trace as ct

    from harness import counters

    wl = registry.workload("veach.pt_nee")
    wl.update(width=8, height=8, frames_per_call=1)
    prog = program.setup(registry.config("veach"), wl, torch.device("cpu"))
    real = ct.cluster_trace
    with counters.kernel_widths() as widths:
        prog.call(prog.new_film(3), 1)
    assert ct.cluster_trace is real
    assert widths and all(0 <= n <= 64 and isinstance(b, bool) for n, b in widths)


def test_work_counter_reads_no_program():
    src = open(work.__file__).read() + open(os.path.join(BENCH, "metrics",
                                                          "cluster_kernel_roofline.py")).read()
    assert "ti_raytrace_tpu" not in src


def test_nothing_loads_jax_or_the_jax_package():
    """A whole run on the CPU (program, reference, control and every metric
    reader) leaves no module named jax, jaxlib, flax or ti_raytrace_tpu,
    compared by whole top-level names."""
    code = f"""
import math, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import torch
from harness import cell, program, registry
from reference import control
bench = registry.spec()
wl = registry.workload("veach.pt_nee"); wl.update(width=8, height=8, frames_per_call=1)
config = registry.config("veach")
prog = program.setup(config, wl, torch.device("cpu"))
for trace in (False, True):
    res, ref = cell.run_cell(prog, wl, config, bench, 3, math.inf, trace, 0.0, max_calls=4)
ctl = control.Control(config, wl, torch.device("cpu"))
res, _ = cell.run_cell(ctl, wl, config, bench, 3, math.inf, False, 0.0, ref=ref, max_calls=1)
for m in bench["per_layer"] + bench["end_to_end"]:
    registry.reader(m["name"])
print("LOADED", cell.jax_loaded(), "ti_raytrace_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED [] True" in out.stdout


def test_jax_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ti_raytrace_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    loaded = cell.jax_loaded()
    assert "jaxlib" in loaded and "ti_raytrace_tpu" not in loaded


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "bench_100k.batch", "--seed", "3000000000", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert "{" not in out.stdout
