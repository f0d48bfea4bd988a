"""The port's diagnostic tools, the public functions it lacked until now
and the non-planar BSDF and light-sampling twins, against the JAX
package's on the CPU, from numpy inputs made from a seed.

Tolerances, with their reasons:
  * numpy on both sides (the oracle's quadrature, region statistics, the
    gamut test), index and layout helpers, PNG decoding: exact;
  * elementwise float32 chains (BSDFs, light sampling, bilinear fetch):
    rtol 1e-5, atol 1e-5 for the bsdf/sample twins and 1e-6 for the
    fetch (XLA on the CPU contracts a*b+c into fused multiply-adds, the
    port rounds every product); discrete choices (lobe, prim) equal on
    >= 99.9% of lanes, since an ulp at a threshold flips one;
  * the display transform: float64 in the port, float32 in JAX: rtol 1e-5;
  * a 16^2 render: the render bar of test_torch_pt_rgb.py (>= 98% of
    pixels within rtol 1e-3, means within 1%), overflow equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_trace import cameras, reference_and_port
from ti_raytrace_tpu_torch.core import rng

torch.set_num_threads(2)

N = 2000


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


# ------------------------------------------------------------ tools

def test_oracle_quadrature_and_display_match_reference():
    from ti_raytrace_tpu.spectral import cie as jcie
    from ti_raytrace_tpu.spectral.spd import Spd as JSpd
    from ti_raytrace_tpu.spectral.spd import load_spd_csv as jload
    from ti_raytrace_tpu.tools import spectral_direct_oracle as jo
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.spectral import cie as tcie
    from ti_raytrace_tpu_torch.spectral.spd import Spd, load_spd_csv
    from ti_raytrace_tpu_torch.tools import spectral_direct_oracle as to

    mesh, lamp, light_id = to.lamp_quad_and_patches()
    jmesh, jlamp, jlight = jo.lamp_quad_and_patches()
    assert light_id == jlight and np.array_equal(lamp, jlamp)
    occ = np.concatenate([np.asarray(t) for i, t in enumerate(mesh.tri_pos)
                          if len(t) and i != light_id], axis=0)
    r = np.random.default_rng(3)
    for _ in range(3):
        p = occ.reshape(-1, 3).mean(axis=0) + r.normal(size=3) * 0.3
        n, cam = _unit(r, 1)[0].astype(np.float64), p + r.normal(size=3) * 5.0
        got = to.integrate_direct(p, n, cam, lamp, 17.3, occ, 0.4, grid=4)
        assert got == jo.integrate_direct(p, n, cam, lamp, 17.3, occ, 0.4, grid=4)

    sensor, jsensor = tcie.load_cie_sensor(), jcie.load_cie_sensor()
    d65, jd65 = tcie.load_d65(), jcie.load_d65()
    d65n = Spd(d65.lambdas, d65.values / tcie.white_point(sensor, d65)[1])
    jd65n = JSpd(jd65.lambdas, jd65.values / jcie.white_point(jsensor, jd65)[1])
    white = load_spd_csv(asset_path("spectrum/white-spec.csv"))
    jwhite = jload(asset_path("spectrum/white-spec.csv"))
    for scalar in (0.05, 0.61546, 3.0):
        disp, lrgb = to.display_value(scalar, white, sensor, d65n)
        jdisp, jlrgb = jo.display_value(scalar, jwhite, jsensor, jd65n)
        np.testing.assert_array_equal(lrgb, jlrgb)
        _close(disp, jdisp)


def test_region_stats_match_reference():
    from ti_raytrace_tpu.tools.spectral_regions import region_stats as jstats
    from ti_raytrace_tpu_torch.tools.spectral_regions import REGIONS, region_stats

    img = np.random.default_rng(5).random((64, 64, 3)).astype(np.float32)
    got, want = region_stats(img, 64), jstats(img, 64)
    assert [r[0] for r in REGIONS] == list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        assert got[k][1] == want[k][1]


def test_plots_match_reference(tmp_path):
    pytest.importorskip("matplotlib")
    from ti_raytrace_tpu.tools import plots as jplots
    from ti_raytrace_tpu_torch.tools import plots

    xy = np.random.default_rng(7).random((500, 2)) * [0.8, 0.9]
    inside = plots.in_srgb_gamut(xy)
    np.testing.assert_array_equal(inside, jplots.in_srgb_gamut(xy))
    assert 0 < inside.sum() < inside.size
    err = plots.colour_check()
    assert err == pytest.approx(jplots.colour_check(), rel=1e-6) and err < 0.01
    plots.draw_chroma(str(tmp_path / "chroma.png"))
    assert (tmp_path / "chroma.png").stat().st_size > 0


# ------------------------------------------------- leftover functions

def test_golden_load_reference_and_image_to_film():
    from ti_raytrace_tpu.io.image import image_to_film as jitf
    from ti_raytrace_tpu.tools.golden import load_reference as jload
    from ti_raytrace_tpu_torch.io.image import film_to_image, image_to_film
    from ti_raytrace_tpu_torch.tools.golden import load_reference

    ref = load_reference("image/skydome.png")
    np.testing.assert_array_equal(ref, jload("image/skydome.png"))
    film = image_to_film(ref)
    np.testing.assert_array_equal(film, jitf(ref))
    np.testing.assert_array_equal(film_to_image(film), ref)


def test_planar_row_helpers_match_reference():
    from ti_raytrace_tpu.ops import planar as jpv
    from ti_raytrace_tpu_torch.ops import planar as pv

    r = np.random.default_rng(9)
    rows = r.normal(size=(40, 3)).astype(np.float32)
    s = r.random(40).astype(np.float32)
    np.testing.assert_array_equal(pv.from_rows(_t(rows)).numpy(), np.asarray(jpv.from_rows(rows)))
    planar = np.ascontiguousarray(rows.T)
    np.testing.assert_array_equal(pv.to_rows(_t(planar)).numpy(), np.asarray(jpv.to_rows(planar)))
    np.testing.assert_array_equal(pv.scale(_t(planar), _t(s)).numpy(),
                                  np.asarray(jpv.scale(planar, s)))
    np.testing.assert_array_equal(pv.splat((1.5, -2.0, 0.25), 7).numpy(),
                                  np.asarray(jpv.splat((1.5, -2.0, 0.25), 7)))


def test_texture_fetches_match_reference():
    from ti_raytrace_tpu.texture import texture as jtex
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.texture import texture as tex

    img = tex.load_texture(asset_path("image/glass.png"))
    np.testing.assert_array_equal(img, jtex.load_texture(asset_path("image/glass.png")))
    h, w = img.shape[:2]
    r = np.random.default_rng(13)
    x = (r.random(N) * (w + 4) - 2).astype(np.float32)
    y = (r.random(N) * (h + 4) - 2).astype(np.float32)
    np.testing.assert_array_equal(tex.sample_nearest(_t(img), _t(x), _t(y)).numpy(),
                                  np.asarray(jtex.sample_nearest(jnp.asarray(img), x, y)))
    u = (r.random(N) * 1.2 - 0.1).astype(np.float32)
    v = (r.random(N) * 1.2 - 0.1).astype(np.float32)
    got = tex.texture2d(_t(img), _t(u), _t(v)).numpy()
    _close(got, jtex.texture2d(jnp.asarray(img), u, v), 1e-6)
    blocks = _t(tex.pack_blocks(img))
    _close(got, tex.texture2d_packed(blocks, _t(u), _t(v)).numpy(), 1e-6)


def test_example_cached_is_the_scene_without_patching():
    """example_cached gives the scene function's own scene through the
    port's npz cache, and changes no attribute of the builder (the
    reference's example_cached patches SceneBuilder.build for the whole
    process)."""
    from ti_raytrace_tpu.examples.scenes import example_cached as jcached
    from ti_raytrace_tpu_torch.examples import scenes
    from ti_raytrace_tpu_torch.scene.build import SceneBuilder

    builder = dict(vars(SceneBuilder))
    for name in ("cornell_box", "prism_rainbow"):
        got, cfg = scenes.example_cached(name, "cpu")
        want, want_cfg = scenes.EXAMPLES[name]("cpu")
        assert dict(vars(SceneBuilder)) == builder and cfg == want_cfg
        for f in got.__dataclass_fields__:
            a, b = getattr(got, f), getattr(want, f)
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f
        js, _ = jcached(name)
        np.testing.assert_array_equal(got.prim_attr.numpy(), np.asarray(js.prim_attr))
    with pytest.raises(ValueError, match="unknown scene"):
        scenes.example_cached("nope", "cpu")


def test_render_frame_stats_and_get_integrator_match_reference():
    """pt_rgb.render_frame_stats against the reference's (16^2
    cornell_box, its schedule, NEE); get_integrator's path tracer is that
    frame, and every integrator name gives a frame renderer."""
    from ti_raytrace_tpu.integrators import pt_rgb as jpt
    from ti_raytrace_tpu_torch.examples import run
    from ti_raytrace_tpu_torch.integrators import pt_rgb as tpt

    js, jcfg, _, ts, tcfg, _ = reference_and_port("cornell_box")
    (jspec, jcam), (tspec, tcam) = cameras("cornell_box", 16)
    want, jov = jpt.render_frame_stats(js, jspec, jcam, jnp.int32(1), jax.random.PRNGKey(4),
                                       compaction=jcfg.compaction, nee=True)
    got, ov = tpt.render_frame_stats(ts, tspec, tcam, 1, rng.PRNGKey(4),
                                     compaction=tcfg.compaction, nee=True)
    assert int(ov) == int(jov) == 0
    a, b = got.numpy(), np.asarray(want)
    assert b.mean() > 0.01
    assert np.isclose(a, b, rtol=1e-3, atol=0.0).all(axis=-1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()

    render = run.get_integrator("pt_rgb", tcfg.sky, tcfg.compaction, ts, tcfg)
    assert torch.equal(render(ts, tspec, tcam, 1, rng.PRNGKey(4)), got)
    for name in run.INTEGRATORS:
        assert callable(run.get_integrator(name, {}, None, ts, tcfg))
    with pytest.raises(ValueError, match="unknown integrator"):
        run.get_integrator("nope", scene=ts)


# ------------------------------------------------- non-planar twins

def test_disney_twin_matches_reference():
    from ti_raytrace_tpu.bsdf import disney as jd
    from ti_raytrace_tpu_torch.bsdf import disney as td

    r = np.random.default_rng(17)
    n, v, l, d = _unit(r, N), _unit(r, N), _unit(r, N), _unit(r, N)
    u3 = r.random((N, 3)).astype(np.float32)
    metal = r.random(N).astype(np.float32)
    rough = r.random(N).astype(np.float32)
    got = td.sample(_t(u3), _t(d), _t(n), _t(metal), _t(rough)).numpy()
    want = np.asarray(jd.sample(u3, d, n, metal, rough))
    assert np.isclose(got, want, rtol=1e-5, atol=1e-5).all(axis=1).mean() >= 0.999
    b, p = td.evaluate_pdf(_t(n), _t(v), _t(l), _t(metal), _t(rough))
    jb, jp = jd.evaluate_pdf(n, v, l, metal, rough)
    assert (np.asarray(jp) > 0).mean() > 0.1
    _close(b.numpy(), jb)
    _close(p.numpy(), jp)
    _close(td.pdf(_t(n), _t(v), _t(l), _t(metal), _t(rough)).numpy(),
           jd.pdf(n, v, l, metal, rough))
    _close(td.evaluate(_t(n), _t(v), _t(l), _t(metal), _t(rough)).numpy(),
           jd.evaluate(n, v, l, metal, rough))


@pytest.mark.parametrize("per_lane", [False, True])
def test_glass_twin_matches_reference(per_lane):
    from ti_raytrace_tpu.bsdf import glass as jg
    from ti_raytrace_tpu_torch.bsdf import glass as tg

    r = np.random.default_rng(19)
    n, d = _unit(r, N), _unit(r, N)
    u = r.random(N).astype(np.float32)
    ior = (1.3 + 0.4 * r.random(N)).astype(np.float32) if per_lane else 1.5
    got_d, got_f = tg.sample(_t(u), _t(d), _t(n), _t(ior) if per_lane else ior)
    want_d, want_f = jg.sample(u, d, n, ior)
    assert np.mean(got_f.numpy() == np.asarray(want_f)) >= 0.999
    assert {-1.0, 1.0} == set(np.unique(np.asarray(want_f)))
    same = got_f.numpy() == np.asarray(want_f)
    _close(got_d.numpy()[same], np.asarray(want_d)[same])
    b, p = tg.evaluate_pdf(_t(n), _t(d), _t(d), ior)
    assert b.shape == (N,) and torch.equal(b, torch.ones(N)) and torch.equal(p, b)
    assert torch.equal(tg.evaluate(_t(n), _t(d), _t(d), ior), tg.pdf(_t(n), _t(d), _t(d), ior))


@pytest.fixture(scope="module")
def emitter_scenes():
    """A box lit by triangle lights, a sphere, a spot and a laser, built
    once by the reference's builder: (JAX scene, port scene, host)."""
    from ti_raytrace_tpu.core import constants as JC
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.scene.build import (MaterialRec, SceneBuilder, laser_shape,
                                             sphere_shape, spot_shape)
    from ti_raytrace_tpu.scene.data import device_scene as jdevice
    from ti_raytrace_tpu_torch.scene.data import device_scene

    b = SceneBuilder()
    b.add_obj(asset_path("model/cornell_box.obj"))
    b.add_shape(sphere_shape([0.0, 1.0, 0.0], 0.2), MaterialRec(JC.MAT_LIGHT, color=[5.0] * 3))
    b.add_shape(spot_shape([0.5, 1.5, 0.0], [0.0, -1.0, 0.0], 0.3, 0.6, 1.0),
                MaterialRec(JC.MAT_LIGHT, color=[7.0] * 3))
    b.add_shape(laser_shape([1.0, 0.5, 2.0], [0.0, 0.0, -1.0], 0.1),
                MaterialRec(JC.MAT_LIGHT, color=[9.0] * 3))
    host = b.build_host()
    return jdevice(host), device_scene(host, "cpu"), host


def _assert_light_sample_close(got, want):
    prim_eq = got.prim.numpy() == np.asarray(want.prim)
    assert prim_eq.mean() >= 0.999
    for f in got._fields:
        a, b = getattr(got, f).numpy()[prim_eq], np.asarray(getattr(want, f))[prim_eq]
        _close(a, b)


def test_sample_li_twin_matches_reference(emitter_scenes):
    from ti_raytrace_tpu.scene import sample as js
    from ti_raytrace_tpu_torch.scene import sample as ts_

    jscene, tscene, host = emitter_scenes
    r = np.random.default_rng(23)
    lo, hi = host["aabb_min"], host["aabb_max"]
    pos = (lo + (hi - lo) * r.random((N, 3))).astype(np.float32)
    u3 = r.random((N, 3)).astype(np.float32)
    got = ts_.sample_li(tscene, _t(pos), _t(u3))
    want = js.sample_li(jscene, jnp.asarray(pos), jnp.asarray(u3))
    assert len(set(got.prim.tolist())) == tscene.n_lights >= 4
    assert (got.emission.numpy() == 0).all(axis=1).any()  # spot cone / laser cylinder
    _assert_light_sample_close(got, want)


def test_sample_light_twin_matches_reference(emitter_scenes):
    from ti_raytrace_tpu.scene import sample as js
    from ti_raytrace_tpu_torch.scene import sample as ts_

    jscene, tscene, _ = emitter_scenes
    u6 = np.random.default_rng(29).random((N, 6)).astype(np.float32)
    got = ts_.sample_light(tscene, _t(u6))
    want = js.sample_light(jscene, jnp.asarray(u6))
    assert len(set(got.prim.tolist())) == tscene.n_lights
    _assert_light_sample_close(got, want)
