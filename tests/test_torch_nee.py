"""The port's NEE path on the Veach MIS scene (bdpt.obj, 11,544 triangles:
the cluster tracer) against the JAX package on the CPU, module by module
and as a whole render.  Both scenes are built here from the OBJ (no npz
cache).  Tolerances, with their reasons:
  * sampling helpers and `sample_li`: rtol 1e-6 / 1e-5 from the same
    numpy inputs (transcendentals differ by an ulp between the two CPU
    libraries; `sample_li` chains a few of them);
  * the host build (smooth normals included): byte-equal, both are numpy;
  * the sorted tracer mode: t within rtol 1e-5 of the BVH oracle (its
    slab/triangle formulas round differently: up to 2.6e-6 relative
    here), prim equal except on t-ties; against the port's own unsorted
    static-order trace, identical (each lane's closest hit does not
    depend on lane order);
  * one `_shade` step with NEE: the carry bar of test_torch_pt_rgb.py;
  * a 16^2 render: >= 98% of pixels within rtol 1e-3 and means within 1%
    (ulp differences flip a few discrete decisions, as in
    test_torch_pt_rgb.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pt_rgb import _assert_carry_close, _to_torch
from ti_raytrace_tpu.integrators import pt_rgb as jpt
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.integrators import pt_rgb as tpt
from ti_raytrace_tpu_torch.ops import cluster_trace as tct

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.scene.build import SceneBuilder as JBuilder
    from ti_raytrace_tpu.scene.data import device_scene as jdevice
    from ti_raytrace_tpu_torch.examples.scenes import veach_host
    from ti_raytrace_tpu_torch.scene.data import device_scene

    jb = JBuilder()
    jb.add_obj(asset_path("model/bdpt.obj"))
    jhost = jb.build_host(smooth_normals=True)
    thost = veach_host()
    return jdevice(jhost), device_scene(thost, "cpu"), jhost, thost


def _cameras(js, ts, size):
    from ti_raytrace_tpu.examples.scenes import ExampleConfig as JConfig
    from ti_raytrace_tpu.examples.scenes import make_camera as jmake
    from ti_raytrace_tpu_torch.examples.scenes import ExampleConfig, make_camera

    return (jmake(js, JConfig("veach_bdpt", "bdpt_rgb", scale_mult=0.5), size, size),
            make_camera(ts, ExampleConfig("veach_bdpt", "bdpt_rgb", scale_mult=0.5),
                        size, size))


def _box_rays(host, n, seed, parked_every=0):
    """Incoherent rays from inside the scene box toward random points of
    it; every parked_every-th lane parked at 1e9 (a dead path)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(host["aabb_min"]), np.asarray(host["aabb_max"])
    o = lo + rng.random((n, 3)) * (hi - lo)
    d = lo + rng.random((n, 3)) * (hi - lo) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if parked_every:
        o[::parked_every] = 1e9
    return (np.ascontiguousarray(o.T.astype(np.float32)),
            np.ascontiguousarray(d.T.astype(np.float32)))


@pytest.mark.parametrize("fn", ["power_heuristic", "length", "uniform_sample_sphere"])
def test_sampling_helpers_match_reference(fn):
    from ti_raytrace_tpu.ops import planar as jpv
    from ti_raytrace_tpu.utils import sampling as jsampling
    from ti_raytrace_tpu_torch.ops import planar as tpv
    from ti_raytrace_tpu_torch.utils import sampling as tsampling

    rng = np.random.default_rng(11)
    if fn == "power_heuristic":
        a, b = (rng.exponential(size=4096).astype(np.float32) for _ in range(2))
        a[:8] = 0.0
        want = jsampling.power_heuristic(jnp.asarray(a), jnp.asarray(b))
        got = tsampling.power_heuristic(torch.from_numpy(a), torch.from_numpy(b))
    elif fn == "length":
        v = rng.normal(size=(3, 4096)).astype(np.float32)
        want = jpv.length(jnp.asarray(v))
        got = tpv.length(torch.from_numpy(v))
    else:
        u1, u2 = rng.random((2, 4096), np.float32)
        want = jpv.uniform_sample_sphere(jnp.asarray(u1), jnp.asarray(u2))
        got = tpv.uniform_sample_sphere(torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_smooth_normals_byte_equal():
    from ti_raytrace_tpu.scene.build import _smooth_normals as jsmooth
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.scene.build import SceneBuilder, _smooth_normals

    b = SceneBuilder()
    b.add_obj(asset_path("model/bdpt.obj"))
    pos, nrm, _, _ = b._concat_tris()
    assert not nrm.any()  # the OBJ has no normals: build_host fills face normals
    fn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    nrm = np.repeat((fn / np.linalg.norm(fn, axis=-1, keepdims=True))[:, None], 3, axis=1)
    got, want = _smooth_normals(pos, nrm.copy()), jsmooth(pos, nrm.copy())
    assert got.dtype == want.dtype and got.shape == want.shape == (11544, 3, 3)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, nrm)  # the smoothing did something


def test_veach_host_matches_reference(scenes):
    """The port's host dict of the Veach scene against the reference's,
    minus the key only the reference reads (`cluster_mt`): the BVH too."""
    _, _, jhost, thost = scenes
    ref_keys = {k for k in jhost if k != "cluster_mt"}
    assert set(thost) == ref_keys
    for k in sorted(ref_keys):
        a, b = np.asarray(thost[k]), np.asarray(jhost[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_veach_light_pack_matches_reference(scenes):
    """The four emissive triangles' light columns, as both device scenes
    hold them, and the light count NEE divides by."""
    js, ts, jhost, _ = scenes
    assert ts.n_lights == js.n_lights == 4
    lp = np.asarray(jhost["light_prim"])
    la = ts.light_attr.numpy()
    np.testing.assert_array_equal(la, np.asarray(js.light_attr))
    np.testing.assert_array_equal(la[22], lp)                      # prim ids
    assert (la[23] == C.PRIM_TRI).all() and (la[18:21] > 1.0).all()  # emitters
    np.testing.assert_array_equal(la[21], jhost["prim_area"][lp])


def test_sample_li_matches_reference(scenes):
    from ti_raytrace_tpu.scene.sample_planar import sample_li as jsample
    from ti_raytrace_tpu_torch.scene.sample_planar import sample_li

    js, ts, jhost, _ = scenes
    rng = np.random.default_rng(3)
    lo, hi = jhost["aabb_min"], jhost["aabb_max"]
    pos = (lo + rng.random((4096, 3)) * (hi - lo)).T.astype(np.float32)
    u3 = rng.random((3, 4096), np.float32)
    want = jsample(js, jnp.asarray(pos), jnp.asarray(u3))
    got = sample_li(ts, torch.from_numpy(pos), torch.from_numpy(u3))
    assert len(np.unique(got["prim"].numpy())) == 4  # every light picked
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_coherence_order_matches_reference(scenes):
    """The port's composed int64 key sorts lanes exactly as the reference's
    two-key (origin, direction) stable sort with padding keys 0xFFFFFFFF;
    padding and parked lanes sort after every live lane in the box."""
    from ti_raytrace_tpu.ops.cluster_trace import _coherence_key as jkey

    js, ts, jhost, _ = scenes
    o, d = _box_rays(jhost, 700, 5, parked_every=9)
    n_pad = 768
    ko, kd = jkey(js, jnp.asarray(o), jnp.asarray(d))
    pad = jnp.full((n_pad - 700,), 0xFFFFFFFF, jnp.uint32)
    _, _, want = jax.lax.sort((jnp.concatenate([ko, pad]), jnp.concatenate([kd, pad]),
                               jnp.arange(n_pad, dtype=jnp.int32)), num_keys=2,
                              is_stable=True)
    got = tct._coherence_order(ts, torch.from_numpy(o), torch.from_numpy(d), n_pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    live = np.flatnonzero(o[0] < 1e8)
    assert set(got[:live.size]) == set(live)


def test_sorted_trace_matches_oracle(scenes):
    """~2k incoherent Veach rays (every 9th parked) through the sorted
    mode of `trace` and `trace_shaded`: against the reference's BVH
    oracle, and identical to the port's own unsorted static-order trace;
    the port's own oracle against the reference's on the same rays."""
    from ti_raytrace_tpu.accel.traverse import trace_closest
    from ti_raytrace_tpu_torch.accel import trace, trace_shaded
    from ti_raytrace_tpu_torch.accel.traverse import trace_closest as port_closest

    js, ts, jhost, _ = scenes
    o, d = _box_rays(jhost, 2000, 7, parked_every=9)
    jt, jp = map(np.asarray, trace_closest(js, jnp.asarray(o.T), jnp.asarray(d.T)))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    pt, pp = map(np.asarray, port_closest(ts, to.T.contiguous(), td.T.contiguous()))
    np.testing.assert_array_equal(pp >= 0, jp >= 0)
    np.testing.assert_allclose(pt, jt, rtol=1e-5, atol=0.0)
    assert (pp != jp).mean() <= 0.002
    t, prim = trace(ts, to, td, sort_small=True)
    t_s, prim_s, uv_s, attr_s = trace_shaded(ts, to, td, sort_small=True)
    t_u, prim_u, uv_u, attr_u = trace_shaded(ts, to, td, sort_rays=False)

    t, prim = t.numpy(), prim.numpy()
    hit = jp >= 0
    assert hit.sum() > 1500 and not hit[::9].any()
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=0.0)
    mismatch = hit & (prim != jp)
    assert mismatch.mean() <= 0.002
    np.testing.assert_allclose(t[mismatch], jt[mismatch], rtol=1e-5, atol=0.0)
    assert (t[~hit] == C.INF).all()

    for a, b in ((t_s, t), (prim_s, prim), (t_u, t), (prim_u, prim),
                 (uv_u, uv_s), (attr_u, attr_s)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shade_nee_step_matches_reference(scenes):
    """One `_shade` with NEE from the reference's camera hit record and
    injected uniforms: sample_li, the shadow trace (sorted mode on both
    sides), the power-heuristic weights and the carry update."""
    from ti_raytrace_tpu.accel import trace_shaded as jtrace

    js, ts, _, _ = scenes
    (jspec, jcam), _ = _cameras(js, ts, 32)
    o, d, _ = jpt._camera_rays(jspec, jcam, jnp.int32(1), jax.random.PRNGKey(4))
    jc = jpt._new_carry(o, d)
    u = np.random.default_rng(2).random((8, jc["alive"].shape[0]), np.float32)
    hit = jtrace(js, o, d, sort_rays=False, sort_small=True, shared_origin=o[:, 0])
    tc = tpt._shade(ts, _to_torch(jc), torch.from_numpy(u),
                    *(torch.from_numpy(np.array(x)) for x in hit), nee=True)
    jc = jpt._shade(js, jc, jnp.asarray(u), *hit, nee=True)
    nee_lanes = (np.asarray(jc["radiance"]) > 0).any(axis=0)
    assert nee_lanes.sum() > 100  # the shadow rays found the lamps
    _assert_carry_close(tc, jc)


@pytest.mark.parametrize("compaction", [None, ((2, 2),)], ids=["exact", "compact_b2"])
def test_veach_render_matches_reference(scenes, compaction):
    """16^2 veach_pt, 2 frames, max_depth 3, NEE on: the exact path, and a
    schedule whose first compaction comes after bounce 2 (bounce 1 in the
    sorted mode, bounce 2 presorted)."""
    from ti_raytrace_tpu import film as jfilm
    from ti_raytrace_tpu_torch import film as tfilm

    js, ts, _, _ = scenes
    (jspec, jcam), (tspec, tcam) = _cameras(js, ts, 16)
    jf, jov = jpt.render_film_frames(js, jspec, jcam, jfilm.new_film(16, 16, seed=5), 2,
                                     compaction, True, max_depth=3)
    tf, tov = tpt.render_film_frames(ts, tspec, tcam, tfilm.new_film(16, 16, seed=5, device="cpu"), 2,
                                     compaction, True, max_depth=3)
    assert tf.frame == int(jf.frame) == 2 and tov == int(jov) == 0
    a, b = tf.hdr.numpy(), np.asarray(jf.hdr)
    assert b.mean() > 0.01
    assert np.isclose(a, b, rtol=1e-3, atol=0.0).all(axis=-1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()


def test_merged_prologue_matches_sequential(scenes):
    """A schedule starting after bounce 2: the merged prologue traces
    bounce 1 in the sorted mode per frame, and group=1 reproduces the
    sequential loop."""
    from ti_raytrace_tpu_torch import film as tfilm

    _, ts, _, _ = scenes
    _, (spec, cam) = _cameras(scenes[0], ts, 16)
    sched = ((2, 2),)
    fm, ovm = tpt.render_film_frames_merged(ts, spec, cam, tfilm.new_film(16, 16, seed=9, device="cpu"),
                                            2, 1, sched, True, max_depth=4)
    fs, ovs = tpt.render_film_frames(ts, spec, cam, tfilm.new_film(16, 16, seed=9, device="cpu"),
                                     2, sched, True, max_depth=4)
    assert fm.frame == fs.frame == 2 and ovm == ovs == 0
    assert float(fs.hdr.mean()) > 0.01
    np.testing.assert_allclose(fm.hdr.numpy(), fs.hdr.numpy(), rtol=1e-5, atol=1e-6)


def test_cli_renders_veach_with_nee(tmp_path, capsys):
    """`run veach_bdpt --integrator pt_rgb` on the CPU: the plain batched
    exact path with NEE, a PNG, and 0 overflow kills in the JSON line."""
    import json

    from ti_raytrace_tpu_torch.examples import run

    out = tmp_path / "veach.png"
    run.main(["veach_bdpt", "--integrator", "pt_rgb", "--size", "8", "--frames", "2",
              "--device", "cpu", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["nee"] and line["frames"] == 2 and line["overflow_kills"] == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # the spectral BDPT runs on it too; the scene has no spectral pack rows,
    # so its emitters carry no power there (the reference renders it black)
    run.main(["veach_bdpt", "--integrator", "bdpt_spec", "--size", "8", "--frames", "1",
              "--device", "cpu", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["integrator"] == "bdpt_spec" and line["frames"] == 1
    assert line["overflow_kills"] == 0 and line["nee"] is None


def test_golden_gate_reads_reference_bounds(capsys):
    """The port's golden gate reads the reference's bound and PNG by path;
    every target of the reference's table renders, prism_rainbow (spectral
    BDPT) among them."""
    import json

    from ti_raytrace_tpu.io.image import image_to_film
    from ti_raytrace_tpu.tools.golden import BOUNDS_PATH as JBOUNDS
    from ti_raytrace_tpu.tools.golden import mean_abs_diff as jdiff
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.io.image import read_image
    from ti_raytrace_tpu_torch.tools import golden

    assert golden.BOUNDS_PATH == JBOUNDS
    ref = read_image(asset_path(golden.TARGETS["veach_pt"][2]))
    assert ref.shape == (512, 512, 3)
    film = image_to_film(ref)
    assert golden.mean_abs_diff(film, ref) == 0.0
    half = film[::2, ::2]  # a 256^2 film: the reference is nearest-resized
    assert golden.mean_abs_diff(half, ref) == jdiff(half, ref) > 0.0
    from ti_raytrace_tpu.tools.golden import TARGETS as JTARGETS

    assert not hasattr(golden, "_UNPORTED") and golden.TARGETS == JTARGETS
    rc = golden.main(["--scene", "prism_rainbow", "--size", "8", "--frames", "1",
                      "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["scene"] == "prism_rainbow" and line["bound"] == 0.0958
    assert line["frames"] == 1 and line["diff"] > 0.0
    assert rc == (0 if line["diff"] <= line["bound"] else 1)
