"""The port's dense tracer (ti_raytrace_tpu_torch/ops/dense_trace.py) and
the tracer dispatch against the JAX package on the CPU, on cornell_box (36
triangles, no shapes), single_model (2,280 triangles + a sphere light)
and, in `test_trace_matches_reference`, prism_rainbow (3,152 triangles, a
sphere light and a laser: a shape that is not a sphere, in a partial last
block of 3,154 prims).

Both packages build each scene with their own recipe (`reference_and_port`
captures the reference's host dict at `SceneBuilder.build`), so the recipes are
held against each other too.  Tolerances, with their reasons:
  * misses and prim ids equal, t within rtol 1e-5 (both sides compute the
    same formulas in f32; XLA on the CPU contracts a*b+c into fused
    multiply-adds, the port rounds every product); on prism_rainbow's
    sphere hits rtol 1e-4: seen from ~465 units, the quadratic's
    b*b - 4*a*c cancels ~2e5 down to ~1e2, so that contraction moves t by
    up to 3.9e-5 of it (37 of 3,281 hits beyond 1e-5, all on the sphere);
  * u/v within atol 1e-4 (that contraction moves barycentrics by up to
    3.6e-5 on the cluster tracer's rays, tests/test_torch_cluster_trace.py);
  * the attribute column exact wherever the prims agree (an index gather
    here, a one-hot matmul at HIGHEST precision there);
  * the port against itself (lane chunks, capped vs uncapped, CUDA vs CPU):
    bit-equal.
The cases that compare the CUDA sweep with the CPU sweep are in
tests/test_torch_dense_gpu.py, which imports no JAX and so also runs on a
machine that has the card and not the JAX package.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_gpu import tie_rays, tie_scene
from ti_raytrace_tpu.ops import dense_trace as jdt
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import dense_trace as tdt

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def reference_and_port(name):
    """(JAX scene, JAX config, reference host dict, port scene on the CPU,
    port config, port host dict) of one example scene, each package
    building it with its own recipe."""
    from ti_raytrace_tpu.examples import scenes as jex
    from ti_raytrace_tpu.scene.build import SceneBuilder as JBuilder
    from ti_raytrace_tpu.scene.data import device_scene as jdevice
    from ti_raytrace_tpu_torch.examples import scenes as tex
    from ti_raytrace_tpu_torch.scene.data import device_scene

    captured = {}
    real_build = JBuilder.build

    def build(self, smooth_normals=False, spectral=False):
        captured["host"] = self.build_host(smooth_normals, spectral)
        return jdevice(captured["host"])

    JBuilder.build = build
    try:
        js, jcfg = jex.EXAMPLES[name]()
    finally:
        JBuilder.build = real_build
    thost = getattr(tex, f"{name}_host")()
    _, tcfg = tex.EXAMPLES[name]("cpu")
    return js, jcfg, captured["host"], device_scene(thost, "cpu"), tcfg, thost


def cameras(name, size):
    """((JAX spec, cam), (port spec, cam)) by each package's framing rule."""
    from ti_raytrace_tpu.examples.scenes import make_camera as jmake
    from ti_raytrace_tpu_torch.examples.scenes import make_camera

    js, jcfg, _, ts, tcfg, _ = reference_and_port(name)
    return jmake(js, jcfg, size, size), make_camera(ts, tcfg, size, size)


def _rays(name, n, seed):
    """Half camera rays (one eye outside the box, aimed into it), half
    incoherent rays between random points of the box (1.2 times its size,
    so some start outside and some miss); planar (3, n) f32."""
    host = reference_and_port(name)[2]
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(host["aabb_min"]), np.asarray(host["aabb_max"])
    c, span = 0.5 * (lo + hi), hi - lo
    eye = c + np.array([0.1, 0.2, 1.0]) * float(np.linalg.norm(span)) * 0.8
    h = n // 2
    o = np.concatenate([np.repeat(eye[None], h, 0),
                        c + (rng.random((n - h, 3)) - 0.5) * span * 1.2])
    tgt = c + (rng.random((n, 3)) - 0.5) * span * 1.2
    if name in ("single_model", "prism_rainbow"):  # a quarter at the sphere light
        tgt[::4] = np.array([0.0, 20.0, 0.0]) + rng.normal(size=(len(tgt[::4]), 3)) * 3.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (np.ascontiguousarray(o.T.astype(np.float32)),
            np.ascontiguousarray(d.T.astype(np.float32)))


@pytest.mark.parametrize("name", ["cornell_box", "single_model", "prism_rainbow"])
def test_trace_matches_reference(name):
    js, _, _, ts, _, _ = reference_and_port(name)
    assert tdt.scene_has_shapes(ts) == jdt.scene_has_shapes(js) == (name != "cornell_box")
    o, d = _rays(name, 4096, 3)
    jt, jp, juv, ja = map(np.asarray, jdt.trace_shaded(js, jnp.asarray(o), jnp.asarray(d)))
    t, prim, uv, attr = (x.numpy() for x in tdt.trace_shaded(
        ts, torch.from_numpy(o), torch.from_numpy(d)))
    hit = jp >= 0
    assert 1000 < hit.sum() < 4096  # hits and misses both
    np.testing.assert_array_equal(prim >= 0, hit)
    assert (t[~hit] == C.INF).all() and (prim[~hit] == -1).all()
    np.testing.assert_array_equal(prim, jp)
    far_sphere = np.zeros_like(hit)  # prism's sphere light: see the docstring
    if name == "prism_rainbow":
        far_sphere = np.isin(jp, [p for p, _ in ts.sphere_prims])
    np.testing.assert_allclose(t[hit & ~far_sphere], jt[hit & ~far_sphere], rtol=1e-5, atol=0.0)
    np.testing.assert_allclose(t[far_sphere], jt[far_sphere], rtol=1e-4, atol=0.0)
    np.testing.assert_allclose(uv, juv, rtol=0.0, atol=1e-4)
    np.testing.assert_array_equal(attr, ja)
    assert not uv[:, ~hit].any() and not attr[:, ~hit].any()
    if name == "single_model":
        assert (prim == ts.n_prims - 1).sum() > 100  # the analytic sphere is hit
        assert not uv[:, prim == ts.n_prims - 1].any()
    if name == "prism_rainbow":  # the sphere light is hit, the laser never
        (sphere, _), = ts.sphere_prims
        assert ts.n_prims == 3154 and ts.n_prims % tdt.BLOCK != 0
        assert (prim == sphere).sum() > 0 and not uv[:, prim == sphere].any()
        assert not (prim >= ts.n_tris)[prim != sphere].any()

    t2, prim2 = tdt.trace_planar(ts, torch.from_numpy(o), torch.from_numpy(d))
    jt2, jp2 = jdt.trace_planar(js, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(t2.numpy(), t)
    np.testing.assert_array_equal(prim2.numpy(), np.asarray(jp2))
    t3, prim3 = tdt.trace_dense(ts, torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy()))
    np.testing.assert_array_equal(t3.numpy(), t)
    np.testing.assert_array_equal(prim3.numpy(), prim)


@pytest.mark.parametrize("name", ["cornell_box", "single_model"])
def test_lane_chunk_changes_nothing(name):
    """The sweep in chunks of one block of lanes (the last one partial)
    equals the sweep of the whole width, bit for bit."""
    ts = reference_and_port(name)[3]
    o, d = (torch.from_numpy(x) for x in _rays(name, 1000, 5))
    t, prim = tdt._sweep(ts, o, d, lane_chunk=4096)
    t_c, prim_c = tdt._sweep(ts, o, d, lane_chunk=128)
    assert int((prim >= 0).sum()) > 300
    assert torch.equal(t, t_c) and torch.equal(prim, prim_c)
    assert tdt.LANE_CHUNK % tdt.BLOCK == 0


@pytest.mark.parametrize("copies", [(5, 77), (3, 130), (130, 3, 131)],
                         ids=["one_block", "two_blocks", "three_copies"])
def test_tie_rule_lowest_prim_wins(copies):
    """Coincident triangles give equal t: the lowest prim index wins,
    inside one block (first minimum) and across two blocks (strict <), in
    the port and in the reference."""
    from ti_raytrace_tpu.scene.data import device_scene as jdevice
    from ti_raytrace_tpu_torch.scene.data import device_scene

    host = tie_scene(copies)
    o, d = tie_rays()
    t, prim, _, attr = tdt.trace_shaded(device_scene(host, "cpu"), o, d)
    assert (prim == min(copies)).all() and torch.allclose(t, torch.full_like(t, 3.0))
    # material 0, area 1/2
    assert (attr[30] == 0).all() and torch.isclose(attr[24], torch.tensor(0.5)).all()
    jhost = dict(host, **{k: np.zeros((1, 3), np.float32) for k in ("bvh_min", "bvh_max")},
                 bvh_prim=np.zeros(1, np.int32), bvh_escape=np.zeros(1, np.int32),
                 cluster_mt=np.zeros((16, 4), np.float32))
    _, jprim = jdt.trace_planar(jdevice(jhost), jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    np.testing.assert_array_equal(np.asarray(jprim), prim.numpy())


def test_capped_trace_matches_uncapped_within_capacity():
    """`trace_planar_capped` equals the uncapped trace on the active lanes
    that fit the capacity, reports a miss on active lanes beyond it, and
    agrees with the reference's capped sweep on every active lane."""
    js, _, _, ts, _, _ = reference_and_port("single_model")
    o, d = _rays("single_model", 2000, 9)
    rng = np.random.default_rng(1)
    active = rng.random(2000) < 0.2
    to, td, ta = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(active)
    t_full, prim_full = tdt.trace_planar(ts, to, td)
    n_act = int(active.sum())
    assert 300 < n_act < 512

    # capacity int(2000 * 0.3) -> 640 lanes: every active lane fits
    t, prim = tdt.trace_planar_capped(ts, to, td, ta, 0.3)
    assert torch.equal(t[ta], t_full[ta]) and torch.equal(prim[ta], prim_full[ta])
    assert int((prim_full[ta] >= 0).sum()) > 100
    jt, jp = jdt.trace_planar_capped(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), 0.3)
    np.testing.assert_array_equal(np.asarray(jp)[active], prim.numpy()[active])
    np.testing.assert_allclose(np.asarray(jt)[active], t.numpy()[active], rtol=1e-5)

    # capacity 256 lanes: the first 256 active lanes keep their hit, the
    # rest read as misses
    t, prim = tdt.trace_planar_capped(ts, to, td, ta, 0.1)
    idx = np.flatnonzero(active)
    kept, cut = idx[:256], idx[256:]
    assert len(cut) > 0
    assert torch.equal(t[kept], t_full[kept]) and torch.equal(prim[kept], prim_full[kept])
    assert (prim[cut] == -1).all() and (t[cut] == C.INF).all()
    assert int((prim_full[cut] >= 0).sum()) > 0  # hits were cut: the cap is lossy there
    _, jp = jdt.trace_planar_capped(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(active), 0.1)
    np.testing.assert_array_equal(np.asarray(jp)[active], prim.numpy()[active])


def test_accel_dispatches_on_prim_count(monkeypatch):
    """At most DENSE_MAX_PRIMS prims: the dense tracer (tmax ignored,
    active + cap_frac -> the capped sweep); above: the cluster tracer."""
    from ti_raytrace_tpu_torch import accel
    from ti_raytrace_tpu_torch.ops import cluster_trace as tct
    from ti_raytrace_tpu_torch.scene.data import device_scene

    ts = reference_and_port("single_model")[3]
    assert ts.n_prims == 2281 <= accel.DENSE_MAX_PRIMS and not accel.needs_presort(ts)
    o, d = (torch.from_numpy(x) for x in _rays("single_model", 600, 4))
    want = tdt.trace_shaded(ts, o, d)

    def no_cluster(*a, **k):
        raise AssertionError("a scene of at most DENSE_MAX_PRIMS prims reached the cluster tracer")

    monkeypatch.setattr(tct, "trace_clustered", no_cluster)
    for g, w in zip(accel.trace_shaded(ts, o, d, sort_rays=False, tile_order=True), want):
        assert torch.equal(g, w)
    t, prim = accel.trace(ts, o, d, tmax=torch.full((600,), 1e-3))
    assert torch.equal(t, want[0]) and torch.equal(prim, want[1])  # tmax ignored
    active = torch.arange(600) % 3 == 0
    t, prim = accel.trace(ts, o, d, active=active, cap_frac=0.5)
    assert torch.equal(prim[active], want[1][active]) and torch.equal(t[active], want[0][active])
    monkeypatch.undo()

    # one prim more than the threshold takes the cluster tracer
    n = accel.DENSE_MAX_PRIMS + 1
    pos = np.zeros((n, 3, 3), np.float32)
    pos[:, :, 0] = np.arange(n)[:, None] * 2.0 + np.array([0.0, 1.0, 0.0])
    pos[:, 2, 1] = 1.0
    from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder

    b = SceneBuilder()
    b.add_triangles(pos, np.zeros_like(pos), np.zeros((n, 3, 2), np.float32),
                    MaterialRec(C.MAT_DISNEY, color=(0.5, 0.5, 0.5), p1=0.5))
    big = device_scene(b.build_host(), "cpu")
    assert big.n_prims == n and accel.needs_presort(big)
    calls = []
    real = tct.trace_clustered
    monkeypatch.setattr(tct, "trace_clustered",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    o = torch.tensor([[0.25, 2.25, 4.25], [0.25, 0.25, 0.25], [3.0, 3.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [-1.0, -1.0, -1.0]])
    t, prim = accel.trace(big, o, d)
    assert len(calls) == 1 and prim.tolist() == [0, 1, 2]
