"""The port's spectral modules (spectral/{spd,cie,rgb2spec}, sky/hosek,
integrators/pt_spec) against the JAX package on the CPU, on sky_dome (the
mirror sphere under the sky) and spectral_box (measured-SPD walls).

Tolerances, with their reasons:
  * host tables (`hero_matrix`, `normalized_d65`, `Rgb2SpecTable.fetch`,
    `build_sky`): both sides are numpy in float64, so bit-equal;
  * `sky_radiance_hero`: rtol 2e-5 against the JAX function (exp, pow
    and cos differ in the last ulps between XLA's CPU library and
    torch's, and F sums terms of both signs), rtol 1e-4 against the
    float64 numpy oracle (float32 on this side);
  * `make_spectral_data`: the float32 tables bit-equal, field by field;
  * one `_bounce`: carry within rtol = atol = 1e-5 on lanes whose alive
    flags agree, and those on >= 99.9% of lanes (an ulp may flip a
    discrete decision), the bar of test_torch_pt_rgb.py;
  * compaction against the exact path: lane widths change the random
    stream, so equal in the mean (2%, the reference's own bar in
    tests/test_spec_perf.py) with zero overflow; a flush by pixel id
    equals the in-place flush bit for bit and clears what it banked;
  * `render_film_frames_spec` against the per-frame loop: bit-equal (one
    key chain); against the JAX frames at 16^2: >= 98% of pixels within
    rtol 1e-3 and image means within 1%, the bar of the RGB renders (an
    ulp flips a discrete decision now and then, and with it a path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_trace import cameras, reference_and_port
from ti_raytrace_tpu.integrators import pt_spec as jps
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import pt_spec as tps

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sdatas():
    """{scene: (JAX SpectralData, port SpectralData)} with each scene's sky."""
    out = {}
    for name in ("sky_dome", "spectral_box"):
        jcfg, tcfg = reference_and_port(name)[1], reference_and_port(name)[4]
        assert jcfg.sky == tcfg.sky
        out[name] = (jps.make_spectral_data(**jcfg.sky), tps.make_spectral_data(**tcfg.sky, device="cpu"))
    return out


def test_host_tables_bit_equal():
    from ti_raytrace_tpu.sky import hosek as jsky
    from ti_raytrace_tpu.spectral import cie as jcie
    from ti_raytrace_tpu.spectral import rgb2spec as jr2s
    from ti_raytrace_tpu.spectral import spd as jspd
    from ti_raytrace_tpu_torch.sky import hosek as tsky
    from ti_raytrace_tpu_torch.spectral import cie as tcie
    from ti_raytrace_tpu_torch.spectral import rgb2spec as tr2s
    from ti_raytrace_tpu_torch.spectral import spd as tspd

    jd65, td65 = jcie.normalized_d65(), tcie.normalized_d65()
    assert td65.values.tobytes() == jd65.values.tobytes()
    assert td65.lambdas.tobytes() == jd65.lambdas.tobytes()
    a, b = tspd.hero_matrix(td65.sample), jspd.hero_matrix(jd65.sample)
    assert a.shape == (4, tspd.HERO_BINS) and a.tobytes() == b.tobytes()
    jsens, tsens = jcie.load_cie_sensor(), tcie.load_cie_sensor()
    assert tcie.white_point(tsens, td65).tobytes() == jcie.white_point(jsens, jd65).tobytes()
    assert (tspd.LAMBDA_STEP, tspd.HERO_BINS) == (jspd.LAMBDA_STEP, jspd.HERO_BINS)

    rgb = np.random.default_rng(0).random((500, 3))
    rgb[:5] = [[0, 0, 0], [1, 1, 1], [1, 0, 0], [0.2, 0.2, 0.2], [0, 1e-7, 0]]
    jt, tt = jr2s.load_table(), tr2s.load_table()
    got, want = tt.fetch(rgb), jt.fetch(rgb)
    assert got.tobytes() == want.tobytes()
    lam = np.linspace(360.0, 760.0, 41)
    assert (tr2s.eval_np(got[:, None, :], lam).tobytes()
            == jr2s.eval_np(want[:, None, :], lam).tobytes())
    with pytest.raises(FileNotFoundError, match="spec_table"):
        tr2s.load_table("/nonexistent/spec_table.npz", generate=False)

    for args in ((3.0, 0.5, 0.17), (2.5, 0.3, 0.6), (10.0, 1.0, 1.2)):
        js, ts = jsky.build_sky(*args), tsky.build_sky(*args)
        assert ts.configs.tobytes() == js.configs.tobytes()
        assert ts.radiances.tobytes() == js.radiances.tobytes()
        assert ts.sun_dir.tobytes() == js.sun_dir.tobytes()
    theta, gamma = np.linspace(0.0, 1.5, 7), np.linspace(0.1, 3.0, 7)
    lam = np.linspace(330.0, 710.0, 7)
    assert (tsky.sky_radiance_np(ts, theta, gamma, lam).tobytes()
            == jsky.sky_radiance_np(js, theta, gamma, lam).tobytes())


def test_hero_select_is_the_one_hot_product():
    from ti_raytrace_tpu.spectral import spd as jspd
    from ti_raytrace_tpu_torch.spectral import spd as tspd

    u = np.random.default_rng(1).random(3000).astype(np.float32)
    u[:3] = [0.0, np.float32(1.0) - np.float32(2.0 ** -24), 0.5]
    table = np.random.default_rng(2).random((12, tspd.HERO_BINS)).astype(np.float32)
    want = np.asarray(jspd.hero_select(jnp.asarray(table), jspd.hero_onehot(jnp.asarray(u))))
    bins = tspd.hero_bin(torch.from_numpy(u))
    assert bins.dtype == torch.int64 and int(bins.max()) == tspd.HERO_BINS - 1
    np.testing.assert_array_equal(
        tspd.hero_select(torch.from_numpy(table), bins).numpy(), want)


def test_sky_radiance_hero_matches_reference():
    from ti_raytrace_tpu.sky import hosek as jsky
    from ti_raytrace_tpu_torch.sky import hosek as tsky

    sky = tsky.build_sky(3.0, 0.5, 0.17)
    r = np.random.default_rng(4)
    n = 4096
    theta = (r.random(n) * 0.5 * np.pi).astype(np.float32)
    gamma = (r.random(n) * np.pi).astype(np.float32)
    lam0 = (360.0 + r.random(n) * 100.0).astype(np.float32)
    lam0[:4] = [360.0, 400.0, 440.0, 459.99]  # on band edges: frac < 1e-6 and near 1
    lam = lam0[None] + np.arange(4, dtype=np.float32)[:, None] * 100.0
    cfg, rad = sky.configs.astype(np.float32), sky.radiances.astype(np.float32)
    want = np.asarray(jsky.sky_radiance_hero(jnp.asarray(cfg), jnp.asarray(rad),
                                             jnp.asarray(theta), jnp.asarray(gamma),
                                             jnp.asarray(lam)))
    got = tsky.sky_radiance_hero(torch.from_numpy(cfg), torch.from_numpy(rad),
                                 torch.from_numpy(theta), torch.from_numpy(gamma),
                                 torch.from_numpy(lam)).numpy()
    assert got.shape == (4, n) and (got[:3] > 0).all() and (got[3] >= 0).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-7)
    oracle = tsky.sky_radiance_np(sky, theta[None], gamma[None], lam.astype(np.float64))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-6)
    assert (got[3, lam[3] > 720.0] == 0).all() and (lam[3] > 720.0).any()


def test_make_spectral_data_matches_reference(sdatas):
    for name, (jsd, tsd) in sdatas.items():
        for f in tsd._fields:
            a, b = getattr(tsd, f), getattr(jsd, f)
            if isinstance(a, float):
                assert a == b, (name, f)
            else:
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name}.{f}")
    assert sdatas["spectral_box"][1].emitter_scale == float(np.sqrt(3.0))
    assert sdatas["sky_dome"][1].emitter_scale == 1.0


def _camera_wavefront(name, size, seed):
    """The reference's raster camera rays (3, N) as numpy."""
    from ti_raytrace_tpu.camera import ray_directions, ray_origins

    (jspec, jcam), _ = cameras(name, size)
    o = np.asarray(ray_origins(jspec, jcam)).T
    d = np.asarray(ray_directions(jspec, jcam, jnp.int32(1), jax.random.PRNGKey(seed))).T
    return np.ascontiguousarray(o), np.ascontiguousarray(d)


def _carry_to_torch(jc):
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    tc["bin"] = tc["bin"].to(torch.int64)
    tc["pixel"] = tc["pixel"].to(torch.int64)
    return tc


def _assert_spec_carry_close(tc, jc, min_alive_agree=0.999):
    agree = tc["alive"].numpy() == np.asarray(jc["alive"])
    assert agree.mean() >= min_alive_agree
    for k in ("origin", "direction", "throughput", "radiance", "miss_dir", "miss_weight",
              "lam0", "light_rad", "spd_vals"):
        a, b = tc[k].numpy(), np.asarray(jc[k])
        np.testing.assert_allclose(a[..., agree], b[..., agree], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(tc["bin"].numpy(), np.asarray(jc["bin"]).astype(np.int64))
    np.testing.assert_array_equal(tc["pixel"].numpy(), np.asarray(jc["pixel"]))


@pytest.mark.parametrize("name", ["spectral_box", "sky_dome"])
def test_bounce_matches_reference(sdatas, name):
    """A fresh carry (`_new_carry_spec` from one key on both sides), then
    two bounces from the reference's carry and one key each: emitter hits,
    NEE with the spectral light rows, measured SPDs / rgb2spec
    reflectances, the deferred sky."""
    js, _, _, ts, _, _ = reference_and_port(name)
    jsd, tsd = sdatas[name]
    o, d = _camera_wavefront(name, 32, 2)
    jc = jps._new_carry_spec(jsd, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(5))
    tc = tps._new_carry_spec(tsd, torch.from_numpy(o), torch.from_numpy(d), rng.PRNGKey(5))
    _assert_spec_carry_close(tc, jc, 1.0)
    for depth in range(2):
        tc_in = _carry_to_torch(jc)
        jc = jps._bounce(js, jsd, jc, jax.random.fold_in(jax.random.PRNGKey(6), depth))
        tc = tps._bounce(ts, tsd, tc_in, rng.fold_in(rng.PRNGKey(6), depth))
        _assert_spec_carry_close(tc, jc)
        if depth == 0:
            alive = np.asarray(jc["alive"])
            assert 20 < alive.sum() < alive.size or name == "spectral_box"
    rad = np.asarray(jc["radiance"])
    missw = np.asarray(jc["miss_weight"])
    if name == "spectral_box":
        assert (rad > 0).any(axis=0).sum() > 100  # NEE and emitter hits landed
    else:
        assert (missw != 0).any(axis=0).sum() > 900  # the sky is seen


def test_flush_by_pixel_equals_flush_in_place(sdatas):
    """`_flush_spec` on a carry with radiance and pending sky misses: the
    scatter by pixel id equals the in-place add (pixel == arange), both
    clear what they banked, and the sky term matches the reference."""
    js, _, _, ts, _, _ = reference_and_port("sky_dome")
    jsd, tsd = sdatas["sky_dome"]
    o, d = _camera_wavefront("sky_dome", 32, 3)
    jc = jps._new_carry_spec(jsd, jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(8))
    jc = jps._bounce(js, jsd, jc, jax.random.PRNGKey(9))
    tc = _carry_to_torch(jc)
    n = tc["alive"].shape[0]
    zero = torch.zeros((3, n))
    c_a, acc_a = tps._flush_spec(tsd, tc, zero, identity=True)
    c_b, acc_b = tps._flush_spec(tsd, tc, zero, identity=False)
    assert torch.equal(acc_a, acc_b) and float(acc_a.sum()) > 0
    for k in ("radiance", "miss_dir", "miss_weight"):
        assert not c_a[k].any() and not c_b[k].any()
    _, acc_again = tps._flush_spec(tsd, c_a, acc_a, identity=False)
    assert torch.equal(acc_again, acc_a)  # a flushed carry banks nothing more
    _, jacc = jps._flush_spec(jsd, jc, jnp.zeros((3, n)), identity=True)
    np.testing.assert_allclose(acc_a.numpy(), np.asarray(jacc), rtol=3e-5, atol=1e-6)


def test_compaction_matches_exact_path(sdatas):
    """A schedule with zero overflow kills estimates what the exact path
    does: same mean over 6 frames of 32^2 (max_depth 6)."""
    from ti_raytrace_tpu_torch import film as tfilm

    ts = reference_and_port("spectral_box")[3]
    tsd = sdatas["spectral_box"][1]
    _, (spec, cam) = cameras("spectral_box", 32)
    means = {}
    for sched in (None, ((2, 2), (5, 8))):
        fl, ov = tps.render_film_frames_spec(ts, tsd, spec, cam, tfilm.new_film(32, 32, seed=5, device="cpu"),
                                             6, sched, max_depth=6)
        assert ov == 0 and fl.frame == 6
        means[sched] = float(fl.hdr.mean())
    exact, compacted = means[None], means[((2, 2), (5, 8))]
    assert exact > 0.1 and abs(compacted - exact) / exact < 0.02


@pytest.mark.parametrize("name", ["spectral_box", "sky_dome"])
def test_film_frames_match_loop_and_reference(sdatas, name):
    """3 frames of 16^2 with the scene's own schedule (sky_dome's starts
    at bounce 1, so its first flush is the in-place one), max_depth 5:
    `render_film_frames_spec` equals the per-frame loop bit for bit and
    matches the JAX film."""
    from ti_raytrace_tpu import film as jfilm
    from ti_raytrace_tpu_torch import film as tfilm

    js, jcfg, _, ts, tcfg, _ = reference_and_port(name)
    jsd, tsd = sdatas[name]
    (jspec, jcam), (tspec, tcam) = cameras(name, 16)
    assert tcfg.compaction == jcfg.compaction
    fl, ov = tps.render_film_frames_spec(ts, tsd, tspec, tcam, tfilm.new_film(16, 16, seed=9, device="cpu"),
                                         3, tcfg.compaction, max_depth=5)
    render_frame = tps.make_render_frame(**tcfg.sky, compaction=tcfg.compaction, max_depth=5,
                                         device="cpu")
    loop = tfilm.new_film(16, 16, seed=9, device="cpu")
    for _ in range(3):
        loop = tfilm.accumulate(loop, render_frame(ts, tspec, tcam, loop.frame, loop.key))
    assert ov == 0 and fl.frame == loop.frame == 3
    assert torch.equal(fl.hdr, loop.hdr) and torch.equal(fl.key, loop.key)

    jf, jov = jps.render_film_frames_spec(js, jsd, jspec, jcam, jfilm.new_film(16, 16, seed=9),
                                          n_frames=3, compaction=jcfg.compaction, max_depth=5)
    assert int(jov) == 0 and int(jf.frame) == 3
    a, b = fl.hdr.numpy(), np.asarray(jf.hdr)
    assert b.mean() > 0.05 and np.isfinite(a).all()
    assert np.isclose(a, b, rtol=1e-3, atol=1e-6).all(axis=-1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()
