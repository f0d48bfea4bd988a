"""The port's BVH oracle against the JAX package on the CPU: the LBVH
build (accel/lbvh.py), the SAH build (accel/sah.py), the stackless
traversal and brute force (accel/traverse.py), the intersection routines
(scene/intersect.py), the `bvh_*` keys of the host dict, and the small
vector, morton and geometry helpers they stand on.  Also the reference's
own BVH and SAH tests (tests/test_scene_bvh.py, tests/test_sah.py) as
cases on the port.

Tolerances, with their reasons:
  * the trees (sorted order, children, every box) and the host dicts:
    byte-equal — the morton quantisation divides in IEEE f32 on both
    sides, the sort is stable on both, and min/max are exact;
  * traversal and brute force against the reference's: misses equal, t
    within rtol 1e-5, prim ids equal but on t-ties (both prims at the same
    distance to rtol 1e-5, at most 1% of hits: a ray through the shared
    edge of a quad's two triangles), as XLA on the CPU fuses multiply-adds
    and the port rounds every product;
  * intersection values and hit attributes: atol 1e-6 (the same);
  * the port against itself (termination spacing, lane packing): equal.
The CUDA cases are in tests/test_torch_bvh_gpu.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_trace import reference_and_port
from ti_raytrace_tpu_torch.accel import lbvh, sah, traverse
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.io.assets import asset_path
from ti_raytrace_tpu_torch.scene import intersect
from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder, laser_shape, sphere_shape
from ti_raytrace_tpu_torch.scene.data import device_scene

torch.set_num_threads(2)


# ------------------------------------------------------------------ inputs

def _soup_boxes(case):
    """Per-primitive AABBs (n, 3) f32 and the scene box of one test soup."""
    rng = np.random.default_rng(7)
    if case == "single":
        pmin = np.zeros((1, 3), np.float32)
        return pmin, pmin + 1.0, pmin[0] - 1.0, pmin[0] + 2.0
    if case == "duplicates":  # one point: every morton code equal
        pmin = np.zeros((64, 3), np.float32)
        pmax = np.full((64, 3), 0.001, np.float32)
        return pmin, pmax, pmin.min(0) - 1, pmax.max(0) + 1
    n = {"pair": 2, "random": 257, "clustered": 3000}[case]
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    if case == "clustered":  # a few tight clumps: long runs of equal codes
        c = (np.round(c / 2.5) * 2.5 + rng.normal(size=(n, 3)) * 1e-4).astype(np.float32)
    half = rng.uniform(0.01, 0.3, (n, 1)).astype(np.float32)
    pmin, pmax = c - half, c + half
    return pmin, pmax, pmin.min(0), pmax.max(0)


def _soup(n, seed, duplicate=False):
    """(pos, nrm, uv) of n random triangles (all at one spot: duplicate)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-3, 3, (n, 1, 3))
    if duplicate:
        v0[:] = 0.5
    pos = (v0 + rng.normal(size=(n, 3, 3)) * 0.4).astype(np.float32)
    if duplicate:
        pos[:] = pos[0]
    return pos, np.zeros_like(pos), np.zeros((n, 3, 2), np.float32)


def _fill(b, recipe, Mat, Sphere, Laser):
    """Apply one soup/shape recipe to a builder of either package."""
    if recipe in ("random_soup", "duplicate_soup"):
        b.add_triangles(*_soup(300, 3, recipe == "duplicate_soup"),
                        Mat(C.MAT_DISNEY, color=(0.5, 0.4, 0.3), p1=0.5))
        b.add_shape(Sphere([0.0, 4.0, 0.0], 0.5), Mat(C.MAT_LIGHT, color=[20.0] * 3))
    else:  # shapes only: spheres and a laser, no triangle
        b.add_shape(Sphere([0.0, 1.0, 0.0], 0.5), Mat(C.MAT_LIGHT, color=[20.0] * 3))
        b.add_shape(Sphere([2.0, 0.0, -1.0], 1.5), Mat(C.MAT_DISNEY, color=(0.5, 0.5, 0.5)))
        b.add_shape(Laser([0.0, 3.0, 0.0], [0.0, -1.0, 0.0], 0.1),
                    Mat(C.MAT_LIGHT, color=[5.0] * 3))
    return b.build_host()


def _host_pair(case, monkeypatch):
    """(reference host dict, port host dict) of one scene build."""
    from ti_raytrace_tpu.scene import build as jb

    if case in ("cornell_box", "prism_rainbow"):
        _, _, jhost, _, _, thost = reference_and_port(case)
        return jhost, thost
    if case == "veach":
        from ti_raytrace_tpu_torch.examples.scenes import veach_host

        b = jb.SceneBuilder()
        b.add_obj(asset_path("model/bdpt.obj"))
        return b.build_host(smooth_normals=True), veach_host()
    if case == "benchmark_2000":
        import ti_raytrace_tpu.scene.data as jdata
        from ti_raytrace_tpu.examples.scenes import benchmark_100k as jbench
        from ti_raytrace_tpu_torch.examples.scenes import benchmark_100k_host

        captured = {}
        monkeypatch.setattr(jdata, "device_scene", lambda host: captured.setdefault("h", host))
        jbench(n_target=2000, cache=False)
        return captured["h"], benchmark_100k_host(2000)
    return (_fill(jb.SceneBuilder(), case, jb.MaterialRec, jb.sphere_shape, jb.laser_shape),
            _fill(SceneBuilder(), case, MaterialRec, sphere_shape, laser_shape))


def _rays(host, n, seed, spread=1.2):
    """n random rays (N, 3) f32 from a box around the scene's."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(host["aabb_min"]), np.asarray(host["aabb_max"])
    o = (0.5 * (lo + hi) + rng.uniform(-spread, spread, (n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _port_builder(path=None, sphere=False):
    b = SceneBuilder()
    b.add_obj(asset_path(path or "model/cornell_box.obj"))
    if sphere:
        b.add_shape(sphere_shape([278.0, 300.0, -280.0], 50.0),
                    MaterialRec(C.MAT_LIGHT, color=[50.0, 50.0, 50.0]))
    return b.build_host()


def _teapot_sphere_pair():
    """(JAX scene, port scene, host) of the Teapot with a sphere light."""
    from ti_raytrace_tpu.scene import build as jb
    from ti_raytrace_tpu.scene.data import device_scene as jdevice

    b = jb.SceneBuilder()
    b.add_obj(asset_path("model/Teapot.obj"))
    b.add_shape(jb.sphere_shape([0.0, 20.0, 0.0], 5.0), jb.MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
    host = b.build_host()
    return jdevice(host), device_scene(host, "cpu"), host


@pytest.fixture(scope="module")
def teapot():
    return _teapot_sphere_pair()


def _assert_oracle_close(t, p, jt, jp, scene, o, d):
    """Misses equal, t within rtol 1e-5, and each differing prim id a
    t-tie: both prims hit the ray at the same distance (rtol 1e-5)."""
    t, p, jt, jp = np.asarray(t), np.asarray(p), np.asarray(jt), np.asarray(jp)
    hit = jp >= 0
    assert hit.sum() > 0
    np.testing.assert_array_equal(p >= 0, hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=0.0)
    assert (t[~hit] == C.INF).all()
    lanes = np.flatnonzero(hit & (p != jp))
    assert lanes.size <= 0.01 * hit.sum()
    if lanes.size:
        sel = torch.from_numpy(lanes)
        mine, theirs = (intersect.intersect_prim_any(scene, o[sel], d[sel], torch.from_numpy(x))
                        for x in (p[lanes], jp[lanes]))
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-5, atol=0.0)


# ------------------------------------------------------------ parity cases

@pytest.mark.parametrize("case", ["single", "pair", "duplicates", "random", "clustered"])
def test_lbvh_device_build_matches_reference(case):
    """build_lbvh_device: sorted order, children and every leaf and
    internal box byte-equal to the reference's; then the threaded flatten."""
    from ti_raytrace_tpu.accel import lbvh as jl

    args = _soup_boxes(case)
    want = jl.build_lbvh_device(*map(jnp.asarray, args))
    got = lbvh.build_lbvh_device(*map(torch.from_numpy, args))
    for k in ("sorted_idx", "left", "right", "leaf_min", "leaf_max", "int_min", "int_max"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
    if case != "single":
        assert bool(got["ready"].all()) and 1 <= got["iterations"] <= args[0].shape[0]
    ref = jl.flatten_threaded({k: np.asarray(v) if hasattr(v, "shape") else v
                               for k, v in want.items()})
    flat = lbvh.flatten_threaded(got)
    for k, v in ref.items():
        assert flat[k].dtype == v.dtype and flat[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("case", ["cornell_box", "veach", "prism_rainbow", "benchmark_2000",
                                  "random_soup", "duplicate_soup", "shapes_only"])
def test_build_host_matches_reference(case, monkeypatch):
    """build_host's dict, the BVH included, byte for byte, minus the one
    key only the reference reads (cluster_mt); the keys in its order."""
    jhost, thost = _host_pair(case, monkeypatch)
    assert list(thost) == [k for k in jhost if k != "cluster_mt"]
    for k, v in thost.items():
        a, b = np.asarray(v), np.asarray(jhost[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
    P = thost["prim_type"].shape[0]
    assert thost["bvh_prim"].shape == (2 * P - 1,) and lbvh.check_coverage(thost, P)
    assert device_scene(thost, "cpu").n_nodes == 2 * P - 1


def test_sah_matches_reference():
    from ti_raytrace_tpu.accel.sah import build_bvh_sah as jsah

    rng = np.random.default_rng(21)
    c = rng.uniform(-4, 4, (300, 3))
    h = rng.uniform(0.05, 0.4, (300, 1))
    want, got = jsah(c - h, c + h), sah.build_bvh_sah(c - h, c + h)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("scene", ["cornell_box", "teapot"])
def test_traversal_matches_reference(scene, teapot):
    """trace_closest and trace_brute_force against the reference's."""
    from ti_raytrace_tpu.accel import traverse as jtr

    if scene == "teapot":
        js, ts, host = teapot
    else:
        js, _, host, ts, _, _ = reference_and_port(scene)
    o, d = _rays(host, 1024, 5)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    _assert_oracle_close(*traverse.trace_closest(ts, to, td), *jtr.trace_closest(js, jo, jd),
                         ts, to, td)
    _assert_oracle_close(*traverse.trace_brute_force(ts, to, td),
                         *jtr.trace_brute_force(js, jo, jd), ts, to, td)
    mask = np.arange(1024) % 3 != 0
    t, p = traverse.trace_closest_masked(ts, to, td, torch.from_numpy(mask))
    jt, jp = jtr.trace_closest_masked(js, jo, jd, jnp.asarray(mask))
    _assert_oracle_close(t, p, jt, jp, ts, to, td)
    assert (p.numpy()[~mask] == -1).all()


def test_intersection_matches_reference(teapot):
    """intersect_tri_soup, intersect_sphere, intersect_prim_any and
    hit_attributes (triangle and sphere hits) to 1e-6."""
    from ti_raytrace_tpu.accel.traverse import trace_closest as jtrace
    from ti_raytrace_tpu.scene import intersect as ji

    js, ts, host = teapot
    o, d = _rays(host, 512, 9, spread=0.8)
    d[:64] = (0.0, -1.0, 0.0)  # the first rays come down onto the sphere light
    o[:64] = np.random.default_rng(4).uniform(-3.0, 3.0, (64, 3)) + (0.0, 40.0, 0.0)
    pid = np.random.default_rng(3).integers(0, host["prim_type"].shape[0], 512).astype(np.int32)
    pid[:32] = host["prim_type"].shape[0] - 1  # the sphere
    to, td, tp = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(pid)

    v0, e1, e2 = (host[k][pid] for k in ("tri_v0", "tri_e1", "tri_e2"))
    got = intersect.intersect_tri_soup(to, td, *map(torch.from_numpy, (v0, e1, e2)))
    want = ji.intersect_tri_soup(o, d, v0, e1, e2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    centre, radius = host["shape_pos"][0], host["shape_param"][0, 0]
    np.testing.assert_allclose(
        intersect.intersect_sphere(to, td, torch.from_numpy(centre), float(radius)).numpy(),
        np.asarray(ji.intersect_sphere(o, d, centre, radius)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(intersect.intersect_prim_any(ts, to, td, tp).numpy(),
                               np.asarray(ji.intersect_prim_any(js, o, d, pid)),
                               rtol=1e-6, atol=1e-6)

    jt, jp = jtrace(js, jnp.asarray(o), jnp.asarray(d))
    jt, jp = np.array(jt), np.array(jp)
    assert (jp >= 0).sum() > 100 and (jp[:64] == pid[0]).all()
    got = intersect.hit_attributes(ts, to, td, torch.from_numpy(jt), torch.from_numpy(jp))
    want = ji.hit_attributes(js, o, d, jt, jp)
    for k in ("valid", "mat_id"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    for k in ("pos", "gnormal", "normal", "uv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_termination_spacing_and_packing_change_nothing(teapot, monkeypatch):
    """The termination test's spacing (every iteration, every 16th, every
    1000th) and the packing of walking lanes give identical results."""
    _, ts, host = teapot
    o, d = map(torch.from_numpy, _rays(host, 700, 2))
    runs = []
    for k in (1, 16, 1000):
        monkeypatch.setattr(traverse, "CHECK_EVERY", k)
        stats = {}
        runs.append(traverse.trace_closest(ts, o, d, stats=stats))
        assert stats["iterations"] > 0
    for t, p in runs[1:]:
        assert torch.equal(t, runs[0][0]) and torch.equal(p, runs[0][1])


def test_vector_helpers_match_reference():
    from ti_raytrace_tpu.utils import geometry as jg
    from ti_raytrace_tpu.utils import morton as jm
    from ti_raytrace_tpu.utils import vec as jv
    from ti_raytrace_tpu_torch.utils import geometry as tg
    from ti_raytrace_tpu_torch.utils import morton as tm
    from ti_raytrace_tpu_torch.utils import vec as tv

    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=(200, 3)).astype(np.float32) for _ in range(3))
    a[0] = 0.0
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    for name in ("dot", "dot3", "cross", "reflect"):
        np.testing.assert_allclose(getattr(tv, name)(ta, tb).numpy(),
                                   np.asarray(getattr(jv, name)(a, b)), rtol=1e-6, atol=1e-6)
    for name in ("length", "normalize", "max_component", "min_component", "sign_nonzero"):
        np.testing.assert_allclose(getattr(tv, name)(ta).numpy(),
                                   np.asarray(getattr(jv, name)(a)), rtol=1e-6, atol=1e-6)

    x = rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32)
    x[:4], y[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1], [0, 3, 2 ** 31, 0]
    tx, ty = torch.from_numpy(x.astype(np.int64)), torch.from_numpy(y.astype(np.int64))
    np.testing.assert_array_equal(tm.clz32(tx).numpy(), np.asarray(jm.clz32(jnp.asarray(x))))
    np.testing.assert_array_equal(tm.common_upper_bits(tx, ty).numpy(),
                                  np.asarray(jm.common_upper_bits(jnp.asarray(x), jnp.asarray(y))))
    q = rng.random((3, 5000)).astype(np.float32)
    np.testing.assert_array_equal(tm.morton3d(*map(torch.from_numpy, q)).numpy(),
                                  np.asarray(jm.morton3d(*q)).astype(np.int64))

    box_min = (c - 1.0).astype(np.float32)
    b[1, 0] = 0.0  # an axis-parallel ray
    hit, t_in = tg.slabs(ta, tb, torch.from_numpy(box_min), tc + 1.0, t_max=3.0)
    jhit, jt_in = jg.slabs(a, b, box_min, c + 1.0, t_max=3.0)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(t_in.numpy(), np.asarray(jt_in), rtol=1e-6)
    p = (a * 0.01).astype(np.float32)
    np.testing.assert_array_equal(tg.offset_ray(torch.from_numpy(p), tb).numpy(),
                                  np.asarray(jg.offset_ray(p, b)))
    n_unit = b / np.linalg.norm(b, axis=-1, keepdims=True)
    i_unit = c / np.linalg.norm(c, axis=-1, keepdims=True)
    for eta in (0.7, 1.5):
        r, ok = tg.refract(torch.from_numpy(i_unit), torch.from_numpy(n_unit), eta)
        jr, jok = jg.refract(i_unit, n_unit, eta)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tg.faceforward(ta, tb, tc).numpy(),
                                  np.asarray(jg.faceforward(a, b, c)))


# ------------------------- the reference's own BVH and SAH tests, on the port

@pytest.fixture(scope="module")
def cornell():
    host = _port_builder()
    return device_scene(host, "cpu"), host


def _compact(host):
    return {k: host[k] for k in ("bvh_min", "bvh_max", "bvh_prim", "bvh_escape")}


def test_cornell_obj_counts():
    from ti_raytrace_tpu_torch.io.obj import load_obj

    mesh = load_obj(asset_path("model/cornell_box.obj"))
    assert len(mesh.materials) == 4 and mesh.triangle_count() == 36
    assert [m.name for m in mesh.materials] == ["white", "red", "green", "light"]


def test_cornell_material_classification(cornell):
    scene, host = cornell
    mt = scene.mat_type.numpy()
    assert mt.shape[0] == 4 and mt[3] == C.MAT_LIGHT and np.all(mt[:3] == C.MAT_DISNEY)
    np.testing.assert_allclose(host["mat_color"][3], [10, 10, 10])  # raw Ke


def test_cornell_lights(cornell):
    scene, host = cornell
    assert scene.n_lights == 2  # the area light's quad
    assert np.all(scene.prim_mat.numpy()[host["light_prim"]] == 3)


def test_bvh_invariants(cornell):
    scene, host = cornell
    compact = _compact(host)
    assert compact["bvh_prim"].shape[0] == 2 * 36 - 1 == scene.n_nodes
    assert lbvh.check_containment(compact) and lbvh.check_coverage(compact, scene.n_prims)
    esc = compact["bvh_escape"]
    assert np.all(esc > np.arange(esc.shape[0])) and np.all(esc <= esc.shape[0])


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_bvh_soup_invariants(case):
    """An odd count that is no power of two, and every prim at one point
    (all morton codes equal: the augmented delta must still make a tree)."""
    pmin, pmax, lo, hi = _soup_boxes(case)
    compact = lbvh.build_bvh(pmin, pmax, lo, hi, device="cpu")
    assert compact["bvh_prim"].shape[0] == 2 * pmin.shape[0] - 1
    assert lbvh.check_containment(compact) and lbvh.check_coverage(compact, pmin.shape[0])


def test_dump_nodes(tmp_path, cornell):
    _, host = cornell
    path = tmp_path / "nodes.txt"
    lbvh.dump_nodes(_compact(host), str(path))
    lines = path.read_text().splitlines()
    assert len(lines) == 71 and lines[0].startswith("0 node prim=-1 escape=71")
    assert sum(" leaf " in line for line in lines) == 36


def test_traversal_matches_brute_force(cornell):
    scene, host = cornell
    o, d = map(torch.from_numpy, _rays(host, 512, 11))
    t_b, p_b = traverse.trace_brute_force(scene, o, d)
    t_t, p_t = traverse.trace_closest(scene, o, d)
    np.testing.assert_allclose(t_t.numpy(), t_b.numpy(), rtol=1e-4, atol=1e-4)
    assert (p_t != p_b).float().mean() < 0.01  # only on equidistant prims


def test_traversal_with_sphere_shape():
    host = _port_builder(sphere=True)
    scene = device_scene(host, "cpu")
    assert scene.n_prims == 37
    t, p = traverse.trace_closest(scene, torch.tensor([[278.0, 300.0, 500.0]]),
                                  torch.tensor([[0.0, 0.0, -1.0]]))
    assert int(p[0]) == 36
    np.testing.assert_allclose(float(t[0]), 500.0 - (-280.0) - 50.0, rtol=1e-4)


def test_teapot_traversal_matches_brute_force():
    host = _port_builder("model/Teapot.obj")
    scene = device_scene(host, "cpu")
    assert scene.n_prims > 1000
    o, d = map(torch.from_numpy, _rays(host, 256, 13, spread=1.5))
    t_b, _ = traverse.trace_brute_force(scene, o, d)
    t_t, _ = traverse.trace_closest(scene, o, d)
    np.testing.assert_allclose(t_t.numpy(), t_b.numpy(), rtol=1e-3, atol=1e-3)


def test_sah_invariants_random():
    rng = np.random.default_rng(21)
    c = rng.uniform(-4, 4, (187, 3))
    h = rng.uniform(0.05, 0.4, (187, 1))
    compact = sah.build_bvh_sah(c - h, c + h)
    assert compact["bvh_prim"].shape[0] == 2 * 187 - 1
    assert lbvh.check_containment(compact) and lbvh.check_coverage(compact, 187)
    esc = compact["bvh_escape"]
    assert np.all(esc > np.arange(len(esc))) and np.all(esc <= len(esc))


def test_sah_traversal_equivalence(cornell):
    """The SAH tree swapped into the scene traces as brute force does."""
    import dataclasses

    scene, host = cornell
    v0, e1, e2 = (host[k] for k in ("tri_v0", "tri_e1", "tri_e2"))
    corners = np.stack([v0, v0 + e1, v0 + e2])
    tree = sah.build_bvh_sah(corners.min(0), corners.max(0))
    swapped = dataclasses.replace(scene, **{k: torch.from_numpy(v) for k, v in tree.items()})
    o, d = map(torch.from_numpy, _rays(host, 256, 3))
    t_sah, _ = traverse.trace_closest(swapped, o, d)
    t_ref, _ = traverse.trace_brute_force(scene, o, d)
    np.testing.assert_allclose(t_sah.numpy(), t_ref.numpy(), rtol=1e-4, atol=1e-4)
