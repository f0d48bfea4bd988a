"""The port's cluster tracer (ti_raytrace_tpu_torch/ops/cluster_trace.py,
plain PyTorch version on the CPU) against the JAX tracer with its Pallas
kernel in interpret mode, in the modes of the render path:

  * camera bounce: one shared origin, _point_order, origin-MT table;
  * merged deep bounces: presorted rays, per-tile order, generic MT;
  * the sorted mode: coherence-sorted rays, per-tile order, unsorted
    results (un-presorted deep bounces, NEE shadow rays);
  * per-lane tmax, active masks and cap_frac (BDPT's shadow batch), on
    the Teapot and on the Veach scene (test_torch_nee.py's fixture).

Tolerances: t within rtol = atol = 1e-5 on hit lanes; prim ids equal
except on t-ties (at most 2% of hits, the tied t within 1e-5, as in
tests/test_cluster.py); misses identical; attributes of matching prims
exact.  u/v within atol 1e-4: u = (T.p) / det with T = o - v0, so a
rounding of T.p is amplified by |T| / |e1| (scene-scale origin distance
over triangle edge length, ~300 on this mesh), and XLA on the CPU
contracts a*b+c into fused multiply-adds (jit(a*b+c) equals the exactly
rounded fma on every element) where the port rounds every product.
Measured: up to 3.6e-5 on these rays, while t agrees to 1e-6.
The CUDA kernel is held against the plain version in test_torch_kernel.py;
here its supercluster table is held against the reference's `sb`, and
the slab test's monotonicity, on which the kernel's supercluster skip
rests, is checked on random boxes and rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_raytrace_tpu.ops import cluster_trace as jct
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import cluster_trace as tct
from test_torch_nee import scenes as veach_scenes  # noqa: F401  (fixture)

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
    """The BDPT modes run on the cluster tracer (the tests below and
    test_torch_bdpt.py), and a scene of at most DENSE_MAX_PRIMS prims
    takes the dense tracer in every mode (test_torch_dense_trace.py).
    What still raises, naming its ROADMAP item: the prism scene and the
    spectral BDPT that renders it."""
    from test_torch_dense_gpu import tie_rays, tie_scene
    from ti_raytrace_tpu_torch.accel import trace
    from ti_raytrace_tpu_torch.examples import run
    from ti_raytrace_tpu_torch.scene.data import device_scene

    _, ts, host = scenes
    o, d = _incoherent_rays(host, 40, 6)
    t, prim = trace(ts, torch.from_numpy(o), torch.from_numpy(d), **kwargs)
    assert t.shape == prim.shape == (40,)
    so, sd = tie_rays(40)
    t, prim = trace(device_scene(tie_scene((5, 77)), "cpu"), so, sd, **kwargs)
    assert (prim == 5).all() and (t == 3.0).all()
    with pytest.raises(NotImplementedError, match="ROADMAP 'to port': spectral BDPT and prism"):
        run.main(["prism_rainbow", "--size", "8", "--device", "cpu"])


def _bounded_rays(scene, host, ts, n, seed):
    """Rays with per-lane bounds as BDPT's shadow batch gives them: a third
    short of their closest hit (from the port's own unbounded trace), a
    tenth parked at 1e-3, the rest past it but below INF (a bound at or
    above INF makes the reference report t == INF with an arbitrary prim;
    shadow rays never carry one).  The Teapot's mix aims a quarter of its
    rays at the light sphere, so the analytic tail runs."""
    if scene == "teapot":
        o, d = _incoherent_rays(host, n, seed)
    else:
        from test_torch_nee import _box_rays

        o, d = _box_rays(host, n, seed)
        o[:, ::10] = 1e9
    t_free = tct.trace_clustered(ts, torch.from_numpy(o), torch.from_numpy(d),
                                 sort_rays=False)[0].numpy()
    rng = np.random.default_rng(seed + 4)
    tmax = np.where(rng.random(n) < 0.33, t_free * 0.5,
                    np.minimum(t_free * 2.0 + 1.0, 1e5)).astype(np.float32)
    tmax[::10] = 1e-3
    return o, d, tmax, t_free


@pytest.mark.parametrize("scene", ["teapot", "veach"])
@pytest.mark.parametrize("mode", ["unsorted", "sorted", "capped"])
def test_trace_tmax_active_matches_reference(request, scene, mode):
    """Per-lane tmax + an active mask (70%), unsorted, sorted with a cap of
    512 lanes that cuts no active lane, and sorted with a cap of 256 that
    cuts some: active lanes compare at the parity bar; lanes cut by their
    bound or by the cap are misses on both sides (the sort orders are
    equal).  The analytic tail sees the bound (a sphere before it hits,
    one beyond it does not) and masks inactive lanes."""
    js, ts, host = request.getfixturevalue("scenes" if scene == "teapot"
                                           else "veach_scenes")[:3]
    o, d, tmax, t_free = _bounded_rays(scene, host, ts, 600, 4)
    active = np.random.default_rng(9).random(600) < 0.7
    cap = {"unsorted": None, "sorted": 0.75, "capped": 0.4}[mode]
    sort_rays = mode != "unsorted"
    ref = jct.trace_clustered(js, jnp.asarray(o), jnp.asarray(d), interpret=True,
                              want_attr=True, sort_rays=sort_rays, sort_small=True,
                              tmax=jnp.asarray(tmax), active=jnp.asarray(active), cap_frac=cap)
    port = tct.trace_clustered(ts, torch.from_numpy(o), torch.from_numpy(d), want_attr=True,
                               sort_rays=sort_rays, sort_small=True,
                               tmax=torch.from_numpy(tmax), active=torch.from_numpy(active),
                               cap_frac=cap)
    a = active
    hit = _assert_trace_parity([np.asarray(x)[..., a] for x in ref],
                               [x[..., torch.from_numpy(a)] for x in port])
    cut = tmax[a] <= t_free[a]
    assert cut.sum() > 100 and not hit[cut].any()  # cut by the bound on both sides
    assert (port[1].numpy()[a][cut] == -1).all()
    if cap is not None:
        lanes = {0.75: 512, 0.4: 256}[cap]
        assert tct.capacity_lanes(600, cap) == jct.capacity_lanes(600, cap) == lanes
    free_hit = (t_free[a] < C.INF) & ~cut
    if mode == "capped":
        assert (free_hit & ~hit).sum() > 20  # the cap cut some active lanes
    else:
        assert hit[free_hit].all()
    if scene == "teapot" and mode != "capped":
        sphere = np.asarray(ref[1])[a] == ts.n_prims - 1
        assert sphere.sum() > 5 and hit[sphere].all()


def test_super_table_matches_reference(scenes):
    """scene.super_bounds (super_table, cluster order) read through an
    order's supercluster sequence equals the reference's `sb` rows of
    _point_order and _tile_order_from_cent (min, max, validity, zero)."""
    js, ts, host = scenes
    nc = host["cluster_bounds"].shape[1]
    S = nc // tct.GROUP
    table = ts.super_bounds.numpy()
    assert table.shape == (8, S)
    np.testing.assert_array_equal(table, tct.super_table(ts.cluster_bounds).numpy())
    origin = np.array([1.5, 4.0, 30.0], np.float32)
    order = tct._point_order(ts.cluster_bounds, nc, torch.from_numpy(origin)).numpy()
    _, _, sb = jct._point_order(js.cluster_bounds, nc, jnp.asarray(origin))
    np.testing.assert_array_equal(table[:, order[0, ::tct.GROUP] // tct.GROUP],
                                  np.asarray(sb)[0, :, :S])
    cent = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32) * 20
    order = tct._tile_order_from_cent(torch.from_numpy(cent), ts.cluster_bounds, nc).numpy()
    _, _, sb = jct._tile_order_from_cent(jnp.asarray(cent), js.cluster_bounds, nc)
    for i in range(5):
        np.testing.assert_array_equal(table[:, order[i, ::tct.GROUP] // tct.GROUP],
                                      np.asarray(sb)[i, :, :S])


def test_super_box_entry_is_monotonic():
    """The kernel's supercluster skip is exact because the slab test is
    monotonic in the box planes: on random cluster boxes grouped in runs of
    32 (with padding boxes) and random rays (axis-parallel, parked at 1e9,
    inside and outside), every ray that enters a valid cluster box before
    its bound enters the run's super box (super_table) at an entry no
    later and an exit no earlier."""
    rng = np.random.default_rng(8)
    nc, n = 256, 512
    lo = rng.normal(size=(3, nc)).astype(np.float32) * 10
    cb = np.zeros((8, nc), np.float32)
    cb[0:3], cb[3:6], cb[6] = lo, lo + rng.random((3, nc)).astype(np.float32) * 8, 1.0
    pad = rng.random(nc) < 0.1
    cb[0:3, pad], cb[3:6, pad], cb[6, pad] = 1e30, -1e30, 0.0
    cb = torch.from_numpy(cb)
    sup = tct.super_table(cb)[:, torch.arange(nc) // tct.GROUP]  # each cluster's super
    o = rng.normal(size=(3, n)).astype(np.float32) * 6
    o[:, ::9] = 1e9
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[rng.integers(0, 3, n // 4), np.arange(n // 4)] = 0.0  # axis-parallel rays
    d /= np.linalg.norm(d, axis=0)
    o, d = torch.from_numpy(o)[:, :, None], torch.from_numpy(d)[:, :, None]
    inv = [tct._safe_inv(d[k]) for k in range(3)]
    best = torch.from_numpy(rng.random((n, 1)).astype(np.float32) * 60)
    tn, tf = tct.slab(cb[:, None, :], o[0], o[1], o[2], *inv)
    sn, sf = tct.slab(sup[:, None, :], o[0], o[1], o[2], *inv)
    cand = (torch.clamp(tn, min=0.0) <= tf) & (cb[6] > 0.0) & (tn < best)
    s_cand = (torch.clamp(sn, min=0.0) <= sf) & (sup[6] > 0.0) & (sn < best)
    assert int(cand.sum()) > 1000
    assert bool(s_cand[cand].all())
    assert bool((sn[cand] <= tn[cand]).all()) and bool((sf[cand] >= tf[cand]).all())


@pytest.mark.parametrize("mode", ["shared_origin", "tile_order", "sorted", "tmax", "capped"])
def test_kernel_inputs_pass_super_table(scenes, mode):
    """kernel_inputs hands the kernel the scene's supercluster table in
    every mode, beside bounds of the scene and an order of whole
    superclusters."""
    _, ts, host = scenes
    o, d = _incoherent_rays(host, 600, 2)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    kw = {"shared_origin": dict(sort_rays=False, shared_origin=o[:, 0].clone()),
          "tile_order": dict(sort_rays=False, tile_order=True),
          "sorted": dict(sort_rays=True),
          "tmax": dict(sort_rays=True, tmax=torch.full((600,), 5.0)),
          "capped": dict(sort_rays=True, tmax=torch.full((600,), 5.0),
                         active=torch.arange(600) % 3 > 0, cap=256)}[mode]
    args, _ = tct.kernel_inputs(ts, o, d, **kw)
    assert len(args) == 9 and args[8] is ts.super_bounds and args[3] is ts.cluster_bounds
    order = args[4].long()
    runs = order.reshape(order.shape[0], -1, tct.GROUP)
    assert bool((runs - runs[..., :1] == torch.arange(tct.GROUP)).all())
    assert bool((runs[..., 0] % tct.GROUP == 0).all())
    assert args[6] == (mode == "shared_origin") and (args[7] is None) == (mode in (
        "shared_origin", "tile_order", "sorted"))
