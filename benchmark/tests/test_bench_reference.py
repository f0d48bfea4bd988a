"""The plain reference on the CPU: its scene and tracer against the port's,
its replay of each cell's call against the program at a small size, and
the comparison's failures: the bfloat16 control and the faults planted
under a run (state unchanged, half the batch left out, an answer
altered).  `gpu`-marked: the same on the card."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from harness import cell, program, registry
from reference import control, render
from reference.plain.examples import scenes as ref_scenes
from reference.plain.ops import cluster_trace as ref_ct

CELLS = [w["name"] for w in registry.spec()["workloads"]]


def _cell(name, size, device="cpu"):
    wl = registry.workload(name)
    wl.update(width=size, height=size)
    config = registry.config(wl["config"])
    return wl, config, program.setup(config, wl, torch.device(device))


@pytest.mark.parametrize("config", ["bench_100k", "veach"])
def test_reference_scene_is_the_programs(config):
    from ti_raytrace_tpu_torch.examples import scenes

    module, name = registry.config(config)["host"].split(":")
    assert module == "scenes"
    ref = getattr(ref_scenes, name)()
    prog = getattr(scenes, name)()
    assert set(ref) <= set(prog)
    for k, v in ref.items():
        assert np.array_equal(np.asarray(v), np.asarray(prog[k])), k


@pytest.mark.parametrize("config,rays", [("veach", 3000), ("bench_100k", 600)])
def test_plain_tracer_is_the_ports(config, rays):
    """The reference's candidate-lane tracer gives the port's plain
    tracer's bits in every mode: sorted, shared origin, tmax, capacity."""
    from ti_raytrace_tpu_torch.ops import cluster_trace as port_ct

    wl, cfg, prog = _cell(f"{config}.{'bdpt' if config == 'veach' else 'batch'}", 8)
    ref = render.build(cfg, wl, "cpu")
    g = torch.Generator().manual_seed(11)
    lo, hi = prog.scene.aabb_min, prog.scene.aabb_max
    o = (lo[:, None] + (hi - lo)[:, None] * torch.rand(3, rays, generator=g)).contiguous()
    d = torch.randn(3, rays, generator=g)
    d = (d / d.norm(dim=0, keepdim=True)).contiguous()
    tmax = torch.rand(rays, generator=g) * (hi - lo).norm()
    active = torch.rand(rays, generator=g) < 0.7
    eye = prog.cam.eye
    cases = [dict(sort_rays=True, sort_small=True),
             dict(sort_rays=False, shared_origin=eye),
             dict(sort_rays=True, sort_small=True, tmax=tmax),
             dict(sort_rays=True, sort_small=True, active=active, cap_frac=0.5)]
    for kw in cases:
        oo = eye[:, None].expand(3, rays).contiguous() if "shared_origin" in kw else o
        a = port_ct.trace_clustered(prog.scene, oo, d, want_attr=True, **kw)
        b = ref_ct.trace_clustered(ref.scene, oo, d, want_attr=True, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y), kw


@pytest.mark.parametrize("name", CELLS)
def test_reference_replays_each_cell(name):
    """One call of each cell at 32x32 (the bench batch at 16x16: a merged
    group is 16 frames), drawn as a run draws it, equals the reference's
    replay to the bit."""
    wl, cfg, prog = _cell(name, 16 if name == "bench_100k.batch" else 32)
    if name == "veach.pt_nee":
        wl["frames_per_call"] = 2
    result, _ = cell.run_cell(prog, wl, cfg, registry.spec(), 2**31 + 9, math.inf, False, 0.0,
                              max_calls=2 if wl["frames_per_call"] < 4 else 1)
    assert result["correct"]
    assert result["checks"]["film_gap"]["value"] == 0.0


@pytest.mark.parametrize("name", ["veach.pt_nee", "veach.bdpt", "bench_100k.preview"])
def test_control_is_not_correct(name):
    """The reference in bfloat16, in the program's place, fails the
    comparison (at 16x16, one frame)."""
    wl, cfg, _ = _cell(name, 16)
    wl["frames_per_call"] = 1
    ctl = control.Control(cfg, wl, torch.device("cpu"))
    result, _ = cell.run_cell(ctl, wl, cfg, registry.spec(), 4, math.inf, False, 0.0,
                              max_calls=1)
    assert not result["correct"]
    assert result["checks"]["film_gap"]["value"] > 1.0


class Broken:
    """The program with a fault planted in what its call returns."""

    def __init__(self, prog, fault: str):
        self.prog, self.fault, self.device = prog, fault, prog.device

    def new_film(self, seed):
        return self.prog.new_film(seed)

    def readback(self, fl):
        return self.prog.readback(fl)

    def call(self, fl, n):
        out, overflow = self.prog.call(fl, n)
        hdr = out.hdr.clone()
        if self.fault == "state_unchanged":
            hdr = fl.hdr
        elif self.fault == "half_left_out":  # every other row keeps its old mean
            hdr[:, ::2] = fl.hdr[:, ::2]
        elif self.fault == "answer_altered":  # one pixel's new sample off by 1%
            x, y = hdr.shape[0] // 2, hdr.shape[1] // 3
            scale = max(float(hdr[x, y, 0].abs()), float(hdr.abs().mean()))
            hdr[x, y, 0] += 0.01 * scale * n / out.frame
        return dataclasses.replace(out, hdr=hdr), overflow


@pytest.mark.parametrize("fault", ["sound", "state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_planted_faults_are_not_correct(fault):
    """A run with the timed path broken underneath reads `correct` false
    (the chip search skipped: 16x16 on the CPU, 1-frame calls)."""
    wl, cfg, prog = _cell("veach.pt_nee", 16)
    wl["frames_per_call"] = 1
    result, _ = cell.run_cell(Broken(prog, fault), wl, cfg, registry.spec(), 6, math.inf,
                              False, 0.0, max_calls=3)
    assert result["correct"] == (fault == "sound"), result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_reference_replays_each_cell_on_the_card(name):
    """As test_reference_replays_each_cell, with the program's kernels on
    the card at 64x64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl, cfg, prog = _cell(name, 64, "cuda")
    cell.warm_up(prog, wl, 1)
    result, _ = cell.run_cell(prog, wl, cfg, registry.spec(), 2**31 + 9, math.inf, False, 0.0,
                              max_calls=2)
    assert result["correct"], result["checks"]
