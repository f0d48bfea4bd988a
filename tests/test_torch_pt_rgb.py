"""The port's path tracer (ti_raytrace_tpu_torch/integrators/pt_rgb.py, on
the CPU with the tracer's plain version) against the JAX integrator.

Scene: the glass Teapot (25,200 tris, so both packages take the cluster
tracer) + sphere light + env map, i.e. the benchmark's configuration
before densification.  Tolerances, with their reasons:
  * one `_shade` step from the same hit record and injected uniforms:
    carry within rtol = atol = 1e-5, alive masks equal on >= 99.9% of
    lanes (an ulp may flip a roulette or refraction decision);
  * a 16^2 merged render from the same seed: film key and frame count
    bit-equal (core/rng is bit-equal), overflow counts equal, >= 98% of
    pixels within rtol 1e-3 and image means within 1% (the residual comes
    from ulp differences — XLA fuses multiply-adds, the port does not —
    that flip a decision and change a whole path);
  * merged group=1 against the port's own sequential loop: the contract
    of the reference (same key chain, same phases), rtol 1e-5.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ti_raytrace_tpu.integrators import pt_rgb as jpt
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.integrators import pt_rgb as tpt

torch.set_num_threads(2)

SCHED = ((1, 2), (3, 4))


@pytest.fixture(scope="module")
def scenes():
    from ti_raytrace_tpu.examples.scenes import cached_host_build
    from ti_raytrace_tpu.io.assets import asset_path
    from ti_raytrace_tpu.io.obj import _load_obj_py
    from ti_raytrace_tpu.scene.build import MaterialRec, SceneBuilder, sphere_shape
    from ti_raytrace_tpu.scene.data import device_scene as jdevice
    from ti_raytrace_tpu_torch.scene.data import device_scene

    def make_host():
        mesh = _load_obj_py(asset_path("model/Teapot.obj"))
        b = SceneBuilder()
        b.add_triangles(np.concatenate(mesh.tri_pos), np.concatenate(mesh.tri_normal),
                        np.concatenate(mesh.tri_uv),
                        MaterialRec(C.MAT_GLASS, color=(0.8, 0.8, 0.8), p0=1.3, p1=5.0))
        b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                    MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
        b.add_env(asset_path("image/env.png"), 5.0)
        return b.build_host()

    host = cached_host_build("torch_parity_glass_teapot", make_host)
    return jdevice(host), device_scene(host, "cpu"), host


def _cameras(host, size):
    from ti_raytrace_tpu.camera import CameraSpec as JSpec
    from ti_raytrace_tpu.camera import orbit_camera as jorbit
    from ti_raytrace_tpu_torch.camera import CameraSpec, orbit_camera

    lo, hi = np.asarray(host["aabb_min"]), np.asarray(host["aabb_max"])
    centre = 0.5 * (lo + hi)
    scale = float(np.linalg.norm(hi - lo)) * 0.8
    return ((JSpec(size, size), jorbit(centre, 0.0, 0.0, scale)),
            (CameraSpec(size, size), orbit_camera(centre, 0.0, 0.0, scale, device="cpu")))


def _to_torch(carry):
    return {k: torch.from_numpy(np.array(v)).to(torch.int64 if k == "pixel" else None)
            for k, v in carry.items()}


def _assert_carry_close(tc, jc, min_alive_agree=0.999):
    alive_j = np.asarray(jc["alive"])
    agree = tc["alive"].numpy() == alive_j
    assert agree.mean() >= min_alive_agree
    for k in ("origin", "direction", "throughput", "radiance", "miss_dir",
              "miss_weight", "brdf_pdf"):
        a, b = tc[k].numpy(), np.asarray(jc[k])
        np.testing.assert_allclose(a[..., agree], b[..., agree], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(tc["perfect_spec"].numpy()[agree],
                                  np.asarray(jc["perfect_spec"])[agree])
    np.testing.assert_array_equal(tc["pixel"].numpy(), np.asarray(jc["pixel"]))


def test_shade_steps_match_reference(scenes):
    """Two bounces of _shade (camera hits, then the refracted/reflected
    continuation rays) from the reference's hit records with injected
    uniforms."""
    from ti_raytrace_tpu.accel import trace_shaded as jtrace

    js, ts, host = scenes
    (jspec, jcam), _ = _cameras(host, 32)
    o, d, _ = jpt._camera_rays(jspec, jcam, jnp.int32(1), jax.random.PRNGKey(2))
    jc = jpt._new_carry(o, d)
    rng = np.random.default_rng(0)
    for step in range(2):
        u = rng.random((8, jc["alive"].shape[0]), np.float32)
        if step == 0:
            hit = jtrace(js, jc["origin"], jc["direction"], sort_rays=False,
                         sort_small=True, shared_origin=jc["origin"][:, 0])
        else:
            hit = jtrace(js, jc["origin"], jc["direction"], sort_rays=False,
                         sort_small=True, tile_order=True)
        tc_in = _to_torch(jc)
        jc = jpt._shade(js, jc, jnp.asarray(u), *hit, nee=False)
        tc = tpt._shade(ts, tc_in, torch.from_numpy(u),
                        *(torch.from_numpy(np.array(x)) for x in hit))
        assert int(np.asarray(jc["alive"]).sum()) > 50
        _assert_carry_close(tc, jc)


def test_env_radiance_matches_reference(scenes):
    js, ts, _ = scenes
    d = np.random.default_rng(1).normal(size=(3, 2000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    a = tpt._env_radiance(ts, torch.from_numpy(d)).numpy()
    b = np.asarray(jpt._env_radiance(js, jnp.asarray(d)))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_merged_render_matches_reference(scenes):
    """16^2, 2 frames in one merged group of 2, schedule ((1,2),(3,4)) with
    the fused flush+compact (pay divisor 2), max_depth 4."""
    from ti_raytrace_tpu import film as jfilm
    from ti_raytrace_tpu_torch import film as tfilm

    js, ts, host = scenes
    (jspec, jcam), (tspec, tcam) = _cameras(host, 16)
    jf, jov = jpt.render_film_frames_merged(js, jspec, jcam, jfilm.new_film(16, 16, seed=5),
                                            2, 2, SCHED, False, pay_divisors=(2,),
                                            max_depth=4)
    tf, tov = tpt.render_film_frames_merged(ts, tspec, tcam, tfilm.new_film(16, 16, seed=5, device="cpu"),
                                            2, 2, SCHED, False, pay_divisors=(2,),
                                            max_depth=4)
    assert tf.frame == int(jf.frame) == 2
    np.testing.assert_array_equal(tf.key.numpy(),
                                  np.asarray(jax.random.key_data(jf.key)).astype(np.int64))
    assert tov == int(jov)
    a, b = tf.hdr.numpy(), np.asarray(jf.hdr)
    assert b.mean() > 0.01
    assert np.isclose(a, b, rtol=1e-3, atol=0.0).all(axis=-1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()


def test_merged_group1_matches_sequential(scenes):
    from ti_raytrace_tpu_torch import film as tfilm

    _, ts, host = scenes
    _, (spec, cam) = _cameras(host, 16)
    fm, ovm = tpt.render_film_frames_merged(ts, spec, cam, tfilm.new_film(16, 16, seed=13, device="cpu"),
                                            2, 1, SCHED, max_depth=4)
    fs, ovs = tpt.render_film_frames(ts, spec, cam, tfilm.new_film(16, 16, seed=13, device="cpu"),
                                     2, SCHED, max_depth=4)
    assert fm.frame == fs.frame == 2 and ovm == ovs
    np.testing.assert_array_equal(fm.key.numpy(), fs.key.numpy())
    np.testing.assert_allclose(fm.hdr.numpy(), fs.hdr.numpy(), rtol=1e-5, atol=1e-6)


def test_overflow_kills_are_counted(scenes):
    """A schedule far below the scene's occupancy cuts live paths, and the
    port reports them (the estimator is then biased, never silently)."""
    from ti_raytrace_tpu_torch import film as tfilm

    _, ts, host = scenes
    _, (spec, cam) = _cameras(host, 128)  # 16384 lanes, ~25% hit: > 1024 alive
    carry = tpt._new_carry(torch.zeros(3, 4096), torch.ones(3, 4096))
    carry["alive"][::2] = False
    _, overflow = tpt._compact(carry, 1024)
    assert int(overflow) == 2048 - 1024
    fl, kills = tpt.render_film_frames_merged(ts, spec, cam, tfilm.new_film(128, 128, seed=1, device="cpu"),
                                              1, 1, ((1, 64),), max_depth=2)
    assert kills > 0 and fl.frame == 1


def test_unported_paths_raise(scenes, capsys):
    """Nothing of the CLI is outside the port any more: its live preview
    runs where pygame is installed and, where it is not (the card's
    machine), raises pygame's own ImportError.  The BDPT tracer modes, the corrected estimator,
    compaction calibration, the dense tracer, the spectral path tracer,
    and now the prism scene (as a CLI scene and as a golden target) and
    the spectral BDPT that renders it, run."""
    import json

    from ti_raytrace_tpu_torch import film as tfilm
    from ti_raytrace_tpu_torch.accel import trace
    from ti_raytrace_tpu_torch.examples import run
    from ti_raytrace_tpu_torch.tools import golden

    _, ts, host = scenes
    _, (spec, cam) = _cameras(host, 16)
    fl = tfilm.new_film(16, 16, device="cpu")
    o, d = torch.zeros(3, 40), torch.ones(3, 40)
    t, _ = trace(ts, o, d, sort_small=True, tmax=torch.ones(40))
    assert t.shape == (40,)
    t, _ = trace(ts, o, d, active=torch.ones(40, dtype=torch.bool), cap_frac=0.5)
    assert t.shape == (40,)
    img = tpt.render_frame(ts, spec, cam, 1, fl.key, corrected=True, max_depth=2)
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
    run.main(["prism_rainbow", "--size", "8", "--frames", "1", "--device", "cpu",
              "--out", "/dev/null"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["integrator"] == "bdpt_spec" and line["overflow_kills"] == 0
    assert golden.main(["--scene", "prism_rainbow", "--size", "8", "--frames", "1",
                        "--device", "cpu"]) in (0, 1)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["scene"] == "prism_rainbow" and line["bound"] == 0.0958
    sched = tpt.calibrate_compaction(ts, spec, cam, probe_size=16, max_depth=3)
    assert sched is None or all(dv >= 2 for _, dv in sched)
    run.main(["cornell_box", "--integrator", "bdpt_spec", "--size", "8", "--frames", "1",
              "--device", "cpu", "--out", "/dev/null"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["integrator"] == "bdpt_spec" and line["frames"] == 1
    with pytest.MonkeyPatch.context() as mp, pytest.raises(ImportError, match="pygame"):
        mp.setitem(sys.modules, "pygame", None)
        run.main(["benchmark_100k", "--preview", "--size", "8", "--device", "cpu"])
    with pytest.raises(ValueError, match="compaction schedule"):
        tpt.render_film_frames_merged(ts, spec, cam, fl, 1, 1, None)
    assert not tpt.has_nee_materials(ts)


def test_nee_is_a_no_op_on_glass(scenes):
    """On a scene of glass and emitters NEE adds nothing: no lane takes a
    light sample (its shadow rays are all parked) and every emitter hit
    ends a specular chain (MIS weight 1), so nee=True renders the same
    film as nee=False, on the merged path and on the exact one."""
    from ti_raytrace_tpu_torch import film as tfilm

    _, ts, host = scenes
    _, (spec, cam) = _cameras(host, 16)
    for sched, merged in ((SCHED, True), (None, False)):
        films = []
        for nee in (False, True):
            fl = tfilm.new_film(16, 16, seed=21, device="cpu")
            if merged:
                fl, ov = tpt.render_film_frames_merged(ts, spec, cam, fl, 2, 2, sched, nee,
                                                       max_depth=4)
            else:
                fl, ov = tpt.render_film_frames(ts, spec, cam, fl, 1, sched, nee, max_depth=4)
            assert ov == 0
            films.append(fl.hdr.numpy())
        assert films[0].mean() > 0.01
        np.testing.assert_array_equal(films[1], films[0])
