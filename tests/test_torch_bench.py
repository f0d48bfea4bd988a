"""The port's benchmark (ti_raytrace_tpu_torch/tools/bench.py, run by
bench_torch.py at the repository root) on the CPU at 16^2: its step is the
merged production path on the benchmark scene's own config, its JSON line
has the keys of the JAX package's bench.py, and overflow kills turn into a
non-zero exit code.  Imports no JAX."""

import dataclasses
import json

import pytest
import torch

from ti_raytrace_tpu_torch.tools import bench

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench_scene():
    """The benchmark scene's recipe at the Teapot's own 25,200 triangles (a
    target below them leaves the mesh as it is), on the CPU."""
    from ti_raytrace_tpu_torch.examples.scenes import benchmark_100k, make_camera

    scene, cfg = benchmark_100k("cpu", n_target=2000)
    return scene, cfg, make_camera(scene, cfg, 16, 16)


def test_step_is_the_merged_production_path(bench_scene):
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.scenes import (BENCH_GROUP, BENCH_PAY_DIVISORS,
                                                       BENCH_SCHEDULE_MERGED)
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    scene, cfg, (spec, cam) = bench_scene
    assert (cfg.group, cfg.compaction, cfg.pay_divisors) == (
        BENCH_GROUP, BENCH_SCHEDULE_MERGED, BENCH_PAY_DIVISORS)
    assert (bench.KF, bench.DISPATCHES, bench.SIZE, bench.BASELINE_FPS) == (128, 5, 512, 30.0)
    step = bench.make_step(scene, dataclasses.replace(cfg, group=2), spec, cam, kf=2)
    fl, kills = step(film_mod.new_film(16, 16))
    want, want_kills = pt_rgb.render_film_frames_merged(
        scene, spec, cam, film_mod.new_film(16, 16), n_frames=2, group=2,
        compaction=BENCH_SCHEDULE_MERGED, nee=False, pay_divisors=BENCH_PAY_DIVISORS)
    assert fl.frame == 2 and kills == want_kills
    assert torch.equal(fl.hdr, want.hdr) and float(fl.hdr.mean()) > 0.0


@pytest.mark.parametrize("case", ["exact", "kills"])
def test_json_line_and_exit_code(bench_scene, case, capsys):
    """A warm-up and two timed dispatches of two frames at 16^2; with a
    schedule that leaves 1/64 of the lanes after bounce 1 (at 128^2, one
    timed frame), paths are cut and the exit code is 1."""
    from ti_raytrace_tpu_torch.examples.scenes import make_camera

    scene, cfg, (spec, cam) = bench_scene
    size, kf, n, sched = 16, 2, 2, None
    if case == "kills":  # a phase keeps at least 1,024 lanes: fewer than 128^2 / 5 alive ones
        size, kf, n, sched = 128, 1, 1, ((1, 64),)
        spec, cam = make_camera(scene, cfg, size, size)
    cfg = dataclasses.replace(cfg, group=kf, compaction=sched or cfg.compaction)
    step = bench.make_step(scene, cfg, spec, cam, kf=kf)
    result = bench.run(step, size, kf, n, "cpu")
    rc = bench.report(dict(result, card="none"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)  # bench.py's keys
    assert line["metric"] == "pt_progressive_fps_100k_tri_512px"
    assert line["unit"] == "fps_at_1spp" and line["device"] == "cpu"
    assert line["frames"] == (n + 1) * kf
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 30.0,
                                                                      abs=1e-3)
    # the value is rounded to 1e-3 fps, coarse at the CPU's fraction of a frame per second
    assert line["ms_per_frame"] == pytest.approx(1e3 / line["value"], rel=2e-2)
    if case == "kills":
        assert line["overflow_kills"] > 0 and rc == 1
    else:
        assert line["overflow_kills"] == 0 and rc == 0


def test_needs_a_card(monkeypatch):
    """No quiet CPU run: without CUDA the entry point exits non-zero and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None) and "CUDA is not available" in str(e.value.code)
