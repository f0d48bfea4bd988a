"""The port's spectral BDPT (ti_raytrace_tpu_torch/integrators/bdpt_spec.py
and the `spec_ctx` branches of bdpt_rgb.py) and its scene, prism_rainbow,
against the JAX package on the CPU.  prism has 3,154 prims (3,152
triangles, a sphere light, a laser), so both packages trace it with their
dense sweep.  Both build the scene with their own recipe
(test_torch_dense_trace.reference_and_port).  Tolerances, with their
reasons:
  * SpecCtx from one key: wavelengths and D65 values equal (the same
    threefry bits, the same f32 table entries; the reference's one-hot
    product at its highest precision adds exact zeros), `sensor_rgb` to
    rtol 1e-6 (three multiply-adds, fused by XLA);
  * `reflect_power`, `light_power_attr`, `light_power_sample` on random
    pack rows: rtol 1e-5 (`rsqrt` differs by ulps between the libraries)
    plus, on the sigmoid, atol 1e-7: it is 0.5 + 0.5 x / sqrt(x^2 + 1),
    which cancels for x << 0 and leaves an ulp of 0.5;
  * the host dict: byte-equal, as for the other scenes; the camera equal;
  * `sample_li` / `sample_light` on prism's two lights: rtol = atol = 1e-5,
    the bar of test_torch_bdpt.py's twin;
  * `build_subpaths` with a context at 16^2: test_torch_bdpt.py's vertex
    bar (counts equal on >= 99.9% of lanes, fields within 1e-5 on >= 99% of
    lanes and 1e-3 on all);
  * whole 16^2 frames through `make_render_frame`: >= 98% of pixels within
    rtol 1e-3 and image means within 1% (one ulp flips a discrete decision
    now and then), the bar of test_torch_bdpt_render.py; about 40% of the
    pixels see the beam or the prism, the others are black in both;
  * the port against itself (walk compaction and the shadow cap with
    enough capacity): bit-equal.
The RGB results with `spec_ctx=None` are held to JAX by test_torch_bdpt.py
and test_torch_bdpt_render.py, unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bdpt import _assert_verts_close, _tkey
from test_torch_dense_trace import cameras, reference_and_port
from ti_raytrace_tpu.integrators import bdpt_rgb as jbd
from ti_raytrace_tpu.integrators import bdpt_spec as jbs
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import bdpt_rgb as tbd
from ti_raytrace_tpu_torch.integrators import bdpt_spec as tbs

torch.set_num_threads(2)

EMITTER_SCALE = float(np.sqrt(3.0))


def _contexts(seed, n, emitter_scale=EMITTER_SCALE):
    key = jax.random.PRNGKey(seed)
    return (jbs.make_spec_ctx_fn(emitter_scale)(key, n),
            tbs.make_spec_ctx_fn(emitter_scale)(_tkey(key), n))


def test_spec_ctx_matches_reference():
    """One wavelength per lane from one key: the bin index (through the
    table values it selects) and lambda equal, the sensor response close."""
    jc, tc = _contexts(3, 4096)
    lam = tc.lam.numpy()
    np.testing.assert_array_equal(lam, np.asarray(jc.lam))
    assert lam.min() >= C.LAMBDA_MIN and lam.max() <= 830.0 and len(np.unique(lam)) > 4000
    np.testing.assert_array_equal(tc.d65_val.numpy(), np.asarray(jc.d65_val))
    np.testing.assert_allclose(tc.sensor_rgb.numpy(), np.asarray(jc.sensor_rgb), rtol=1e-6,
                               atol=1e-4)
    assert tc.sensor_rgb.shape == (3, 4096) and float(tc.sensor_rgb.min()) == 0.0
    # the emitter scale folds into the D65 table only
    _, t1 = _contexts(3, 4096, 1.0)
    assert torch.equal(t1.lam, tc.lam) and torch.equal(t1.sensor_rgb, tc.sensor_rgb)
    np.testing.assert_allclose(tc.d65_val.numpy(), t1.d65_val.numpy() * np.float32(EMITTER_SCALE),
                               rtol=1e-7)


@pytest.mark.parametrize("fn", ["reflect_power", "light_power_attr", "light_power_sample",
                                "to_rgb"])
def test_spec_ctx_powers_match_reference(fn):
    """The context's four functions on random pack rows: coefficients of
    the size rgb2spec fits, emission scales of the prism's lights."""
    jc, tc = _contexts(4, 4096)
    r = np.random.default_rng(8)
    attr = np.zeros((40, 4096), np.float32)
    for rows in ((32, 33, 34), (35, 36, 37)):
        attr[rows[0]] = r.normal(size=4096) * 1e-4
        attr[rows[1]] = r.normal(size=4096) * 0.1
        attr[rows[2]] = r.normal(size=4096) * 20.0
    attr[38] = r.exponential(size=4096) * 500.0
    # what multiplies the sigmoid in the light powers (1 elsewhere)
    scale = tc.d65_val.numpy().astype(np.float64) * attr[38] if "light" in fn else 1.0
    if fn == "light_power_sample":
        ls = dict(em_c0=attr[35], em_c1=attr[36], em_c2=attr[37], em_scale=attr[38])
        for vis in (None, (r.random(4096) > 0.3).astype(np.float32)):
            if vis is not None:
                ls["vis"] = vis
            want = jc.light_power_sample({k: jnp.asarray(v) for k, v in ls.items()})
            got = tc.light_power_sample({k: torch.from_numpy(v) for k, v in ls.items()})
            assert got.shape == (1, 4096)
            np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale,
                                       rtol=1e-5, atol=1e-7)
        assert (got.numpy()[0][vis == 0.0] == 0.0).all()
        return
    if fn == "to_rgb":
        power = r.exponential(size=(1, 4096)).astype(np.float32)
        want, got = jc.to_rgb(jnp.asarray(power)), tc.to_rgb(torch.from_numpy(power))
    else:
        want = getattr(jc, fn)(jnp.asarray(attr))
        got = getattr(tc, fn)(torch.from_numpy(attr))
        assert got.shape == (1, 4096)
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale, rtol=1e-5,
                               atol=0.0 if fn == "to_rgb" else 1e-7)
    assert 0.0 < float(got.mean())


def test_prism_host_and_camera_match_reference():
    """prism_rainbow by each package's recipe: every pack array equal (the
    laser's shape rows and pi r^2 area among them), the config and the
    fixed framing equal."""
    from ti_raytrace_tpu.examples.scenes import framing_params as jframing
    from ti_raytrace_tpu_torch.examples.scenes import framing_params

    js, jcfg, jhost, ts, tcfg, thost = reference_and_port("prism_rainbow")
    ref_keys = {k for k in jhost if not k.startswith("bvh_") and k != "cluster_mt"}
    assert set(thost) == ref_keys
    for k in sorted(ref_keys):
        a, b = np.asarray(thost[k]), np.asarray(jhost[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert ts.n_prims == js.n_prims == 3154 and ts.n_lights == js.n_lights == 2
    la = thost["light_attr"]
    assert list(la[24]) == [C.SHAPE_SPHERE, C.SHAPE_LASER]
    np.testing.assert_allclose(la[21], [np.pi * 25.0, np.pi * 0.01], rtol=1e-6)  # pi r^2
    assert la[28, 1] == np.float32(0.1) and list(la[25:28, 1]) == [0.0, 0.0, -1.0]
    assert thost["prim_attr"][32:39].any() and la[32:36].any()  # spectral rows filled
    for f in ("name", "integrator", "scale_mult", "fixed_scale", "fixed_target", "yaw", "pitch",
              "exposure", "sky", "compaction", "group", "batch", "bdpt_walk_compaction",
              "bdpt_shadow_cap"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.integrator == "bdpt_spec" and tcfg.bdpt_shadow_cap == 0.09
    for a, b in zip(framing_params(ts, tcfg), jframing(js, jcfg)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    (_, jcam), (_, tcam) = cameras("prism_rainbow", 16)
    np.testing.assert_array_equal(tcam.view.numpy(), np.asarray(jcam.view))
    np.testing.assert_array_equal(tcam.eye.numpy(), np.asarray(jcam.eye))
    # the framing rule of the other scenes is untouched by the fixed branch
    _, box_cfg, _, box, tbox_cfg, _ = reference_and_port("cornell_box")
    assert framing_params(box, tbox_cfg)[3] == jframing(reference_and_port("cornell_box")[0],
                                                        box_cfg)[3]


@pytest.mark.parametrize("fn", ["sample_li", "sample_light"])
def test_prism_light_sampling_matches_reference(fn):
    """The emitter samplers on the first scene that holds a laser, from
    injected uniforms: the beam's visibility cut at its radius, direction
    pdf 1 and choice pdf 1/L on the laser's lanes."""
    from ti_raytrace_tpu.scene import sample_planar as jsp
    from ti_raytrace_tpu_torch.scene import sample_planar as tsp

    js, _, _, ts, _, _ = reference_and_port("prism_rainbow")
    r = np.random.default_rng(9)
    u6 = r.random((6, 4096), np.float32)
    if fn == "sample_light":
        want = jsp.sample_light(js, jnp.asarray(u6))
        got = tsp.sample_light(ts, torch.from_numpy(u6))
    else:
        # receivers around the beam's axis (x = 1, y = 0), inside and outside it
        pos = np.stack([1.0 + r.normal(size=4096) * 0.15, r.normal(size=4096) * 0.15,
                        r.uniform(-9.0, 8.0, size=4096)]).astype(np.float32)
        want = jsp.sample_li(js, jnp.asarray(pos), jnp.asarray(u6[:3]))
        got = tsp.sample_li(ts, torch.from_numpy(pos), torch.from_numpy(u6[:3]))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    laser = got["prim"].numpy() == ts.n_prims - 1
    assert 1500 < laser.sum() < 2600
    assert (got["dir_pdf"].numpy()[laser] == 1.0).all()
    assert (got["dir_pdf_std"].numpy()[laser] == 1.0).all()
    assert (got["choice_pdf"].numpy()[laser] == 0.5).all()
    if fn == "sample_li":
        vis = got["vis"].numpy()
        assert set(np.unique(vis[laser])) == {0.0, 1.0} and (vis[~laser] == 1.0).all()
    else:
        off = got["pos"].numpy()[:, laser] - np.array([[1.0], [0.0], [9.0]], np.float32)
        assert np.linalg.norm(off, axis=0).max() <= 0.1 + 1e-6 and np.abs(off[2]).max() < 1e-6
        np.testing.assert_array_equal(got["direction"].numpy()[:, laser],
                                      np.broadcast_to([[0.0], [0.0], [-1.0]], off.shape))


def _reference_spectral_subpaths(seed, compaction, max_depth=3):
    """The reference's keys, context, camera rays and subpaths of one 16^2
    prism frame, on the key chain of `make_render_frame`."""
    from ti_raytrace_tpu.camera import ray_directions as jdirs

    js = reference_and_port("prism_rainbow")[0]
    (jspec, jcam), _ = cameras("prism_rainbow", 16)
    k_lam, k_path = jax.random.split(jax.random.PRNGKey(seed))
    k_eye, k_light, _ = jax.random.split(k_path, 3)
    k_cam, k_ewalk = jax.random.split(k_eye)
    n = jspec.width * jspec.height
    ctx = jbs.make_spec_ctx_fn(EMITTER_SCALE)(k_lam, n)
    o = jnp.broadcast_to(jcam.eye[:, None], (3, n))
    d = jnp.swapaxes(jdirs(jspec, jcam, jnp.int32(1), k_cam), 0, 1)
    out = jbd.build_subpaths(js, o, d, k_ewalk, k_light, ctx, eye_depth=max_depth + 2,
                             light_depth=max_depth + 1, walk_compaction=compaction,
                             return_overflow=True)
    return (k_lam, k_ewalk, k_light, o, d), out


@pytest.mark.parametrize("case", ["full_width", "scene_compaction"])
def test_spectral_subpaths_match_reference(case):
    """16^2, max_depth 3 (eye walk 5 vertices, light walk 4) with a
    context: at full width, and with the scene's walk compaction (fronts
    of 256, 128 and 128 lanes before depths 2, 3 and 4)."""
    ts, tcfg = reference_and_port("prism_rainbow")[3:5]
    sched = tcfg.bdpt_walk_compaction if case == "scene_compaction" else None
    (k_lam, k_ewalk, k_light, o, d), ref = _reference_spectral_subpaths(31, sched)
    ctx = tbs.make_spec_ctx_fn(EMITTER_SCALE)(_tkey(k_lam), 256)
    port = tbd.build_subpaths(ts, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)),
                              _tkey(k_ewalk), _tkey(k_light), eye_depth=5, light_depth=4,
                              walk_compaction=sched, return_overflow=True, spec_ctx=ctx)
    assert int(port[4]) == int(ref[4]) == 0
    assert len(port[0]) == len(ref[0]) == 5 and len(port[2]) == len(ref[2]) == 4
    # the beam reaches the prism and the eye sees it
    assert (np.asarray(ref[1]) >= 3).sum() > 20 and (np.asarray(ref[3]) >= 3).sum() > 50
    # vertex 0's beta is one row wide, the walk's vertices three equal rows
    assert port[0][0]["beta"].shape == port[2][0]["beta"].shape == (1, 256)
    for verts in (port[0], port[2]):
        for vt in verts[1:]:
            assert vt["beta"].shape == vt["reflect"].shape == (3, 256)
            assert torch.equal(vt["beta"][0], vt["beta"][2])
            assert torch.equal(vt["reflect"][0], vt["reflect"][1])
    _assert_verts_close(port[0], port[1], ref[0], ref[1])
    _assert_verts_close(port[2], port[3], ref[2], ref[3])


def test_spectral_render_matches_reference():
    """Two 16^2 frames through `make_render_frame` with the scene's emitter
    scale, walk compaction and shadow cap, as the CLI renders them."""
    js, jcfg, _, ts, tcfg, _ = reference_and_port("prism_rainbow")
    (jspec, jcam), (tspec, tcam) = cameras("prism_rainbow", 16)
    jrender = jbs.make_render_frame(**jcfg.sky, walk_compaction=jcfg.bdpt_walk_compaction,
                                    shadow_cap=jcfg.bdpt_shadow_cap)
    trender = tbs.make_render_frame(**tcfg.sky, walk_compaction=tcfg.bdpt_walk_compaction,
                                    shadow_cap=tcfg.bdpt_shadow_cap)
    for frame, seed in ((1, 21), (2, 22)):
        want = np.asarray(jrender(js, jspec, jcam, jnp.int32(frame), jax.random.PRNGKey(seed)))
        got, overflow = trender(ts, tspec, tcam, frame, rng.PRNGKey(seed), return_overflow=True)
        got = got.numpy()
        assert int(overflow) == 0
        assert got.shape == want.shape == (16, 16, 3) and np.isfinite(got).all()
        assert want.mean() > 1.0 and 0.2 < (want != 0).any(axis=-1).mean() < 0.8
        assert np.isclose(got, want, rtol=1e-3, atol=0.0).all(axis=-1).mean() >= 0.98
        assert abs(got.mean() - want.mean()) <= 0.01 * want.mean()
    assert torch.equal(trender(ts, tspec, tcam, 2, rng.PRNGKey(22)), torch.from_numpy(got))


# ------------------------------------------------ the port against itself

def _spectral_state(n=512, seed=10):
    """A spectral walk front of n lanes, two thirds alive, every row
    distinct per lane."""
    r = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32))

    v0 = tbd._eye_vertex0(f(3, n), f(3, n), 1)
    ctx = tbs.SpecCtx(lam=f(n), d65_val=f(n), sensor_rgb=f(3, n))
    st = tbd._walk_state(f(3, n), f(3, n), f(1, n), f(n), v0, 3, ctx)
    st["alive"] = torch.from_numpy(r.random(n) < 2.0 / 3.0)
    return st


@pytest.mark.parametrize("new_n", [512, 384, 128])
def test_compaction_carries_wavelength_and_counts_overflow(new_n):
    """`_compact_walk_front` on a spectral front: every row of the new
    front, the wavelength and the D65 value among them, is the old front's
    row of that lane; alive lanes come first in lane order; the overflow is
    the alive lanes beyond the capacity (0 when it suffices)."""
    st = _spectral_state()
    before = {k: st[k].clone() for k in ("o", "d", "beta", "pdf_fwd", "prev_pos", "prev_normal",
                                          "lam", "d65", "alive")}
    n_alive = int(before["alive"].sum())
    assert 128 < n_alive < 384
    overflow = tbd._compact_walk_front(st, new_n)
    assert int(overflow) == max(n_alive - new_n, 0)
    lane = st["lane"]
    assert lane.shape == (new_n,) and st["compacted"] and st["beta"].shape == (1, new_n)
    for k, v in before.items():
        assert torch.equal(st[k], v[..., lane]), k
    kept = min(n_alive, new_n)
    assert bool(st["alive"][:kept].all()) and not bool(st["alive"][kept:].any())
    assert bool((lane[:kept][1:] > lane[:kept][:-1]).all())


@pytest.fixture()
def lane_free_draws(monkeypatch):
    """Every lane of a wavefront draws the same uniforms (one column,
    repeated): a lane's result then does not depend on its position in
    the front, which a compaction changes.  Returns a 256-lane context
    drawn before that, with a wavelength of its own on every lane."""
    real = rng.uniform
    ctx = tbs.make_spec_ctx_fn(EMITTER_SCALE)(rng.PRNGKey(5), 256)

    def uniform(key, shape, device=None):
        return real(key, shape[:-1] + (1,), device).expand(shape).contiguous()

    monkeypatch.setattr(tbd.rng, "uniform", uniform)
    return ctx


def test_walk_compaction_with_capacity_is_identity(lane_free_draws):
    """With draws that do not depend on the lane's position, a walk
    compaction whose capacity covers the live lanes changes nothing: the
    subpaths and the whole frame (the splat's per-lane conversion to sRGB
    included) are bit-equal to the uncompacted ones.  A stale wavelength
    on a compacted front, or a splat converted with the front's context,
    would show here."""
    ts = reference_and_port("prism_rainbow")[3]
    _, (spec, cam) = cameras("prism_rainbow", 16)
    ctx = lane_free_draws
    assert len(torch.unique(ctx.lam)) > 250
    key = rng.PRNGKey(6)
    # the light lanes share one start (one draw): they live and die together
    sched = (((2, 1.3), (3, 2.0)), ((2, 1.0), (3, 1.0)))
    k_eye, k_light, _ = rng.split(key, 3)
    k_cam, k_ewalk = rng.split(k_eye)
    o, d = tbd._camera_rays(spec, cam, 1, k_cam)
    plain = tbd.build_subpaths(ts, o, d, k_ewalk, k_light, return_overflow=True, spec_ctx=ctx)
    packed = tbd.build_subpaths(ts, o, d, k_ewalk, k_light, walk_compaction=sched,
                                return_overflow=True, spec_ctx=ctx)
    assert int(plain[4]) == int(packed[4]) == 0
    # eye paths that lived through the first compaction, and through both
    assert int((plain[1] >= 3).sum()) > 10 and int((plain[1] >= 4).sum()) > 0
    for a, b in ((plain[0], packed[0]), (plain[2], packed[2])):
        for va, vb in zip(a, b):
            for k in va:
                assert torch.equal(va[k], vb[k]), k
    assert torch.equal(plain[1], packed[1]) and torch.equal(plain[3], packed[3])
    img = tbd.render_paths(ts, spec, cam, 1, key, spec_ctx=ctx)
    img_c, ov = tbd.render_paths(ts, spec, cam, 1, key, spec_ctx=ctx, walk_compaction=sched,
                                 return_overflow=True)
    assert int(ov) == 0 and float(img.mean()) > 0.0 and torch.equal(img, img_c)


def test_shadow_cap_with_capacity_is_identity_and_counts_kills():
    """The capped shadow batch of one prism frame: with a capacity that
    covers its active lanes the frame is bit-equal to the uncapped one and
    nothing is counted; below them, every active lane cut is counted, and
    the cut lanes read as occluded."""
    from ti_raytrace_tpu_torch.accel import trace_capacity

    ts = reference_and_port("prism_rainbow")[3]
    _, (spec, cam) = cameras("prism_rainbow", 16)
    ctx = tbs.make_spec_ctx_fn(EMITTER_SCALE)(rng.PRNGKey(5), 256)
    key = rng.PRNGKey(7)
    k_eye, k_light, k_conn = rng.split(key, 3)
    k_cam, k_ewalk = rng.split(k_eye)
    o, d = tbd._camera_rays(spec, cam, 1, k_cam)
    eye, ec, light, lc = tbd.build_subpaths(ts, o, d, k_ewalk, k_light, spec_ctx=ctx)
    pairs = [(e, l) for e in range(1, 8) for l in range(0, 7)
             if not ((l == 1 and e == 1) or l + e - 2 < 0 or l + e - 2 > tbd.MAX_DEPTH)]
    sels = tbd._shadow_requests(ts, spec, cam, eye, ec, light, lc, k_conn, pairs)[3]
    n_all, active = len(sels) * 256, int(torch.cat(sels).sum())
    assert len(sels) == 20 and 128 < active < 0.5 * n_all

    def run(cap):
        return tbd._connections(ts, spec, cam, eye, ec, light, lc, k_conn, shadow_cap=cap,
                                spec_ctx=ctx)

    rad, splat, kills = run(None)
    assert int(kills) == 0 and float(rad.sum()) > 0.0 and float(splat.abs().sum()) > 0.0
    enough = (active + 128) / n_all
    assert trace_capacity(ts, n_all, enough) >= active
    rad_c, splat_c, kills_c = run(enough)
    assert int(kills_c) == 0 and torch.equal(rad_c, rad) and torch.equal(splat_c, splat)
    small = 128 / n_all
    assert trace_capacity(ts, n_all, small) == 128
    rad_s, _, kills_s = run(small)
    assert int(kills_s) == active - 128
    assert float(rad_s.sum()) < float(rad.sum())
