"""The port's cluster tracer (ti_raytrace_tpu_torch/ops/cluster_trace.py,
plain PyTorch version on the CPU) against the JAX tracer with its Pallas
kernel in interpret mode, in the modes of the render path:

  * camera bounce: one shared origin, _point_order, origin-MT table;
  * merged deep bounces: presorted rays, per-tile order, generic MT;
  * the sorted mode: coherence-sorted rays, per-tile order, unsorted
    results (un-presorted deep bounces, NEE shadow rays).

Tolerances: t within rtol = atol = 1e-5 on hit lanes; prim ids equal
except on t-ties (at most 2% of hits, the tied t within 1e-5, as in
tests/test_cluster.py); misses identical; attributes of matching prims
exact.  u/v within atol 1e-4: u = (T.p) / det with T = o - v0, so a
rounding of T.p is amplified by |T| / |e1| (scene-scale origin distance
over triangle edge length, ~300 on this mesh), and XLA on the CPU
contracts a*b+c into fused multiply-adds (jit(a*b+c) equals the exactly
rounded fma on every element) where the port rounds every product.
Measured: up to 3.6e-5 on these rays, while t agrees to 1e-6.
The CUDA kernel is held against the plain version in test_torch_kernel.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_raytrace_tpu.ops import cluster_trace as jct
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import cluster_trace as tct

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    """The dryrun Teapot (25,200 tris + sphere light: > 4096 prims, so the
    reference traces it with the cluster kernel), in both packages."""
    from ti_raytrace_tpu.examples.scenes import cached_host_build
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.scene.build import MaterialRec, SceneBuilder, sphere_shape
    from ti_raytrace_tpu.scene.data import device_scene as jdevice
    from ti_raytrace_tpu_torch.scene.data import device_scene

    def make_host():
        b = SceneBuilder()
        b.add_obj(asset_path("model/Teapot.obj"))
        b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                    MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
        return b.build_host()

    host = cached_host_build("dryrun_teapot", make_host)
    return jdevice(host), device_scene(host, "cpu"), host


def _box(host):
    lo, hi = np.asarray(host["aabb_min"]), np.asarray(host["aabb_max"])
    return 0.5 * (lo + hi), hi - lo


def _incoherent_rays(host, n, seed):
    """Outside-in and inside-out rays (tests/test_cluster.py's mix), plus
    rays aimed at the light sphere so the analytic tail is exercised."""
    rng = np.random.default_rng(seed)
    c, span = _box(host)
    r = float(np.linalg.norm(span))
    o = np.concatenate([
        c + rng.normal(size=(n // 2, 3)) * r * 0.8,
        c + rng.normal(size=(n - n // 2, 3)) * r * 0.05,
    ]).astype(np.float32)
    tgt = np.where((np.arange(n) % 4 == 0)[:, None],
                   np.array([0.0, 20.0, 0.0]) + rng.normal(size=(n, 3)),
                   c + rng.normal(size=(n, 3)) * span * 0.3)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)


def _camera_rays(host, n, seed):
    rng = np.random.default_rng(seed)
    c, span = _box(host)
    eye = (c + np.array([0.3, 0.5, 1.0]) * float(np.linalg.norm(span)) * 0.8).astype(np.float32)
    tgt = c[:, None] + rng.normal(size=(3, n)) * span[:, None] * 0.3
    o = np.repeat(eye[:, None], n, axis=1)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, np.ascontiguousarray(d)


def _assert_trace_parity(ref, port):
    jt, jp, juv, ja = map(np.asarray, ref)
    tt, tp, tuv, ta = (x.numpy() for x in port)
    hit = jt < 1e5
    assert hit.sum() > 50
    np.testing.assert_allclose(np.where(hit, tt, 0.0), np.where(hit, jt, 0.0),
                               rtol=1e-5, atol=1e-5)
    mismatch = hit & (tp != jp)
    assert mismatch.mean() <= 0.02
    np.testing.assert_allclose(tt[mismatch], jt[mismatch], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tp[~hit], jp[~hit])
    assert (tt[~hit] == C.INF).all()
    np.testing.assert_allclose(tuv, juv, rtol=0, atol=1e-4)
    same = tp == jp
    np.testing.assert_array_equal(ta[:, same], ja[:, same])
    return hit


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_camera_mode_matches_reference(scenes, seed):
    js, ts, host = scenes
    o, d = _camera_rays(host, 600, seed)
    ref = jct.trace_clustered(js, jnp.asarray(o), jnp.asarray(d), interpret=True,
                              want_attr=True, sort_rays=False, sort_small=True,
                              shared_origin=jnp.asarray(o[:, 0]))
    port = tct.trace_clustered(ts, torch.from_numpy(o), torch.from_numpy(d), want_attr=True,
                               sort_rays=False, sort_small=True,
                               shared_origin=torch.from_numpy(o[:, 0].copy()))
    _assert_trace_parity(ref, port)


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_deep_mode_matches_reference(scenes, seed):
    """Presorted incoherent rays with a per-tile front-to-back order (the
    merged deep bounces); 600 lanes = 3 tiles, the last one partial."""
    js, ts, host = scenes
    o, d = _incoherent_rays(host, 600, seed)
    ref = jct.trace_clustered(js, jnp.asarray(o), jnp.asarray(d), interpret=True,
                              want_attr=True, sort_rays=False, sort_small=True,
                              tile_order=True)
    port = tct.trace_clustered(ts, torch.from_numpy(o), torch.from_numpy(d), want_attr=True,
                               sort_rays=False, sort_small=True, tile_order=True)
    hit = _assert_trace_parity(ref, port)
    sphere = np.asarray(ref[1]) == ts.n_prims - 1
    assert sphere.sum() > 10 and hit[sphere].all()  # the analytic tail is exercised


def test_orders_and_origin_mt_table_match_reference(scenes):
    js, ts, host = scenes
    nc = host["cluster_bounds"].shape[1]
    origin = np.array([1.5, 4.0, 30.0], np.float32)
    j_order, _, _ = jct._point_order(js.cluster_bounds, nc, jnp.asarray(origin))
    np.testing.assert_array_equal(
        tct._point_order(ts.cluster_bounds, nc, torch.from_numpy(origin)).numpy(),
        np.asarray(j_order)[0])
    cent = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32) * 20
    j_tile, _, _ = jct._tile_order_from_cent(jnp.asarray(cent), js.cluster_bounds, nc)
    np.testing.assert_array_equal(
        tct._tile_order_from_cent(torch.from_numpy(cent), ts.cluster_bounds, nc).numpy(),
        np.asarray(j_tile)[:, 0])
    np.testing.assert_array_equal(
        tct._static_order(ts.cluster_bounds, nc).numpy(),
        np.asarray(jct._static_order(js.cluster_bounds, nc)[0])[0])
    mt_j = np.asarray(jct._origin_mt_table(js.cluster_tri, jnp.asarray(origin)))
    mt_t = tct._origin_mt_table(ts.cluster_tri, torch.from_numpy(origin)).numpy()
    assert mt_t.shape == mt_j.shape == (12, nc * tct.CLUSTER_B)
    np.testing.assert_allclose(mt_t, mt_j, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(mt_t[9], mt_j[9])  # prim ids ride along exactly


def test_coherence_key_matches_reference(scenes):
    js, ts, host = scenes
    o, d = _incoherent_rays(host, 500, 3)
    o[:, ::7] = 1e9  # parked lanes
    ko, kd = jct._coherence_key(js, jnp.asarray(o), jnp.asarray(d))
    to, td = tct._coherence_key(ts, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(to.numpy(), np.asarray(ko).astype(np.int64))
    np.testing.assert_array_equal(td.numpy(), np.asarray(kd).astype(np.int64))


def test_cpu_dispatch_uses_plain_version(scenes):
    """A CPU wavefront takes cluster_trace_plain: the kernel's launch count
    does not move, and the dispatcher's result is the plain version's."""
    _, ts, host = scenes
    o, d = _incoherent_rays(host, 300, 5)
    before = tct.KERNEL.launches
    t, prim, _ = tct.trace_clustered(ts, torch.from_numpy(o), torch.from_numpy(d),
                                     sort_rays=False, tile_order=True)
    assert tct.KERNEL.launches == before
    assert (prim >= 0).sum() > 50 and (t[prim < 0] == C.INF).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_sorted_mode_matches_reference(scenes, seed):
    """Incoherent rays through the sorted mode (coherence sort, per-tile
    order from the sorted tiles, unsort), with parked lanes; 600 lanes =
    3 tiles, the last one partial."""
    js, ts, host = scenes
    o, d = _incoherent_rays(host, 600, seed)
    o[:, 1::11] = 1e9  # parked lanes
    ref = jct.trace_clustered(js, jnp.asarray(o), jnp.asarray(d), interpret=True,
                              want_attr=True, sort_rays=True, sort_small=True)
    port = tct.trace_clustered(ts, torch.from_numpy(o), torch.from_numpy(d), want_attr=True,
                               sort_rays=True, sort_small=True)
    hit = _assert_trace_parity(ref, port)
    assert not hit[1::11].any()


@pytest.mark.parametrize("kwargs", [
    dict(sort_rays=True, sort_small=True, tmax=torch.ones(40)),
    dict(sort_rays=False, tmax=torch.ones(40)),
    dict(sort_rays=False, active=torch.ones(40, dtype=torch.bool), cap_frac=0.5),
])
def test_unported_modes_raise(scenes, kwargs):
    _, ts, host = scenes
    o, d = _incoherent_rays(host, 40, 6)
    with pytest.raises(NotImplementedError, match="ROADMAP 'to port': BDPT RGB"):
        tct.trace_clustered(ts, torch.from_numpy(o), torch.from_numpy(d), **kwargs)
