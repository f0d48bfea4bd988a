"""The dense tracer's span (`dense_trace._sweep`, ops/dense_trace.py): while
it records, its attributes (the lanes `n`, the table's `groups` and its
sphere rows `tail`; `capped` and `n_uncapped` under a capped sweep) and,
on the card, the kernel's own (warp, group) counts as a device tensor;
while nothing records, no span, not one torch call more than the plain
path, and the kernel launched with counts=None.  No JAX, so the `gpu`
cases also run on the GPU machine:

    python -m pytest tests/test_torch_dense_spans.py -m gpu --noconftest -p no:cacheprovider
"""

import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.ops import dense_trace as dt
from ti_raytrace_tpu_torch.tools.profile_bdpt import _OpCounter, count_ops

SPAN = "dense_trace._sweep"


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


def _scene(device):
    from ti_raytrace_tpu_torch.examples import scenes

    return scenes.example_cached("single_model", device)


def _rays(scene, n, seed):
    """n seeded rays from inside the scene's box, a quarter of them aimed
    at the box's centre (the glass sphere)."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = scene.aabb_min.cpu(), scene.aabb_max.cpu()
    o = lo[:, None] + (hi - lo)[:, None] * (torch.rand(3, n, generator=g) * 1.4 - 0.2)
    d = torch.randn(3, n, generator=g)
    k = n // 4
    d[:, :k] = (0.5 * (lo + hi))[:, None] - o[:, :k]
    d = d / d.norm(dim=0, keepdim=True)
    return o.contiguous().to(scene.device), d.contiguous().to(scene.device)


def _camera_rays(scene, cfg, size):
    """single_model's camera wavefront at size^2, as pt_rgb traces it."""
    from ti_raytrace_tpu_torch.camera import ray_directions_morton
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.examples.scenes import make_camera

    spec, cam = make_camera(scene, cfg, size, size)
    d = ray_directions_morton(spec, cam, 1, rng.PRNGKey(4))
    return cam.eye[:, None].expand(3, d.shape[1]).contiguous(), d


def _sweeps():
    return [r for r in metrics.spans() if r.name == SPAN]


@pytest.mark.parametrize("n", [0, 1, 600])
def test_recording_span_carries_width_groups_and_tail_on_the_cpu(fresh, n):
    """On the CPU (the plain sweep) the recording span carries the launch's
    width and the table's shape, and no counts: nothing was launched."""
    scene, _ = _scene("cpu")
    o, d = _rays(scene, max(n, 1), 3)
    o, d = o[:, :n].contiguous(), d[:, :n].contiguous()
    with metrics.recording():
        t, prim = dt.trace_planar(scene, o, d)
    (span,) = _sweeps()
    groups = scene.dense_boxes.shape[0]
    assert span.attrs == {"n": n, "groups": groups,
                          "tail": scene.dense_rows.shape[0] - dt.GROUP * groups}
    assert (groups, span.attrs["tail"]) == (72, 1)  # 2,280 triangles, the sphere light
    t_p, p_p = dt._sweep(scene, o, d)
    assert torch.equal(t, t_p) and torch.equal(prim, p_p)


def test_capped_sweep_records_its_width_before_the_cap(fresh):
    scene, _ = _scene("cpu")
    o, d = _rays(scene, 1000, 5)
    active = torch.arange(1000) % 3 == 0
    with metrics.recording():
        dt.trace_planar_capped(scene, o, d, active, 0.4)
    (span,) = _sweeps()
    assert span.attrs["capped"] is True and span.attrs["n_uncapped"] == 1000
    assert span.attrs["n"] == dt.capacity_lanes(1000, 0.4) == 512


def test_off_the_span_records_nothing_and_adds_no_torch_call(fresh, monkeypatch):
    """With recording off, `trace_shaded` makes the top-level torch calls of
    the plain path (the same function with `_sweep` in the span's place),
    and records nothing; with recording on, on the CPU, no more either."""
    scene, _ = _scene("cpu")
    o, d = _rays(scene, 600, 7)
    off = _OpCounter()
    with off:
        dt.trace_shaded(scene, o, d)
    on = count_ops(lambda: dt.trace_shaded(scene, o, d))
    assert len(_sweeps()) == 1
    metrics.clear_spans()
    monkeypatch.setattr(dt, "trace_planar", lambda s, o_, d_: dt._sweep(s, o_, d_))
    plain = _OpCounter()
    with plain:
        dt.trace_shaded(scene, o, d)
    assert sum(off.counts.values()) == sum(plain.counts.values()) == sum(on.values()) > 0
    assert metrics.spans() == []


@pytest.mark.gpu
def test_span_counts_are_the_kernels_own(cuda, fresh):
    """single_model's 512^2 camera wavefront: the recording span's counts
    equal a direct launch's counts on the same rays, and t and prim are
    bit-equal with counts and without, and to the plain sweep."""
    scene, cfg = _scene("cuda")
    o, d = _camera_rays(scene, cfg, 512)
    counts = torch.zeros(5, dtype=torch.int32, device="cuda")
    t0, p0 = dt.DENSE_KERNEL(o, d, scene.dense_boxes, scene.dense_rows, counts)
    with metrics.recording():
        t1, p1 = dt.trace_planar(scene, o, d)
    t2, p2 = dt.trace_planar(scene, o, d)
    (span,) = _sweeps()
    got = span.attrs["counts"]
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert got.tolist() == counts.tolist() and counts[0] > 0
    assert span.attrs["n"] == 512 * 512 and span.attrs["groups"] == 72
    t_p, p_p = dt._sweep(scene, o, d)
    for t, p in ((t1, p1), (t2, p2), (t_p, p_p)):
        assert torch.equal(t, t0) and torch.equal(p, p0)


@pytest.mark.gpu
def test_off_the_kernel_gets_no_counts(cuda, fresh, monkeypatch):
    """With nothing recording the wrapper launches the kernel as before,
    counts=None; recording, with a fresh (5,) int32 tensor each call."""
    scene, cfg = _scene("cuda")
    o, d = _camera_rays(scene, cfg, 64)
    seen = []
    real = dt.DENSE_KERNEL

    def spy(*args):
        seen.append(args[4] if len(args) > 4 else None)
        return real(*args)

    monkeypatch.setattr(dt, "DENSE_KERNEL", spy)
    dt.trace_shaded(scene, o, d)
    assert seen == [None] and metrics.spans() == []
    with metrics.recording():
        dt.trace_shaded(scene, o, d)
        dt.trace_shaded(scene, o, d)
    a, b = seen[1:]
    assert a is not b and a.shape == (5,) and a.dtype == torch.int32
    sweeps = _sweeps()
    assert len(sweeps) == 2 and all(s.attrs["counts"] is x for s, x in zip(sweeps, (a, b)))
