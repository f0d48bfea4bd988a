"""The port's BDPT (ti_raytrace_tpu_torch/integrators/bdpt_rgb.py) on the
Veach MIS scene against the JAX package on the CPU (Pallas in interpret
mode, torch with the tracer's plain version), module by module; whole
renders are in test_torch_bdpt_render.py.  Both scenes are built from
the OBJ (test_torch_nee.py's fixture, no npz cache).  Tolerances, with
their reasons:
  * `sample_light` and `_mis_weight`: rtol 1e-5 from the same numpy
    inputs (a few transcendentals and divisions, an ulp each; atol 1e-5
    for the spot fade, which cancels near its outer edge);
  * `disney_evaluate_pdf`: rtol 1e-5 against JAX (XLA fuses the
    multiply-adds of the GTR2 and Schlick polynomials; measured up to
    8.5e-6 relative, in both pdf modes alike), and the true-pdf mode's
    own change, the diffuse density cos/pi for 1/pi, to rtol 1e-6;
  * raster directions rtol 1e-6; `project`'s truncated pixels equal on
    >= 99.9% of the points both call visible (an ulp at a pixel edge
    moves one), the visibility mask likewise;
  * `build_subpaths` at 16^2: the carry bar of test_torch_pt_rgb.py
    (vertex counts equal on >= 99.9% of lanes, every vertex field of
    every depth within rtol = atol = 1e-5), on >= 99% of the lanes of a
    field and within 1e-3 on all: a near-specular Disney sample divides
    by GTR2's 1 + (a^2 - 1) cos^2, which cancels, so an ulp of the two
    packages' rounding grows to ~1e-4 relative on a lane or two;
  * `_connections` at 16^2 from the reference's subpaths: the render bar
    (>= 98% of pixels within rtol 1e-3, means within 1%; an ulp flips an
    occlusion or MIS decision now and then).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nee import _cameras, scenes  # noqa: F401  (fixture)
from ti_raytrace_tpu.integrators import bdpt_rgb as jbd
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.integrators import bdpt_rgb as tbd
from ti_raytrace_tpu_torch.ops import cluster_trace as tct

torch.set_num_threads(2)

FLOAT_FIELDS = ("pos", "normal", "snormal", "wo", "beta", "reflect", "fpdf", "rpdf",
                "delta", "area", "metallic", "roughness")
INT_FIELDS = ("vtype", "prim", "mat_type", "mat_index")


def _tkey(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def _tverts(verts):
    return [{k: torch.from_numpy(np.array(v)) for k, v in vt.items()} for vt in verts]


def _light_scene(ts):
    """The Veach light pack plus a sphere, a spot and a laser column, so
    every branch of the emitter samplers runs."""
    from types import SimpleNamespace

    la = ts.light_attr.numpy().copy()
    extra = np.zeros((la.shape[0], 3), np.float32)
    for j, (stype, p28, p29, p30) in enumerate(((C.SHAPE_SPHERE, 0.5, 0.0, 0.0),
                                                (C.SHAPE_SPOT, 0.3, 0.6, 1.5),
                                                (C.SHAPE_LASER, 0.2, 0.0, 0.0))):
        extra[0:3, j] = (1.0 + j, 2.0, -1.0)
        extra[18:21, j] = (5.0, 4.0, 3.0)
        extra[21, j] = 0.7 + j
        extra[22, j] = 100 + j
        extra[23, j] = C.PRIM_SHAPE
        extra[24, j] = stype
        extra[25:28, j] = np.array([0.2, -1.0, 0.3]) / np.linalg.norm([0.2, -1.0, 0.3])
        extra[28:31, j] = (p28, p29, p30)
    la = np.concatenate([la, extra], axis=1)
    return (SimpleNamespace(light_attr=jnp.asarray(la), n_lights=la.shape[1]),
            SimpleNamespace(light_attr=torch.from_numpy(la), n_lights=la.shape[1]))


def test_sample_light_matches_reference(scenes):  # noqa: F811
    from ti_raytrace_tpu.scene.sample_planar import sample_li as jsample_li
    from ti_raytrace_tpu.scene.sample_planar import sample_light as jsample
    from ti_raytrace_tpu_torch.scene.sample_planar import sample_li, sample_light

    _, ts, _, _ = scenes
    jl, tl = _light_scene(ts)
    rng = np.random.default_rng(5)
    u6 = rng.random((6, 4096), np.float32)
    want = jsample(jl, jnp.asarray(u6))
    got = sample_light(tl, torch.from_numpy(u6))
    assert len(np.unique(got["prim"].numpy())) == 7  # every light picked
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    pos = rng.normal(size=(3, 4096)).astype(np.float32) * 3.0
    want = jsample_li(jl, jnp.asarray(pos), jnp.asarray(u6[:3]))
    got = sample_li(tl, torch.from_numpy(pos), torch.from_numpy(u6[:3]))
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_true_pdf_matches_reference():
    from ti_raytrace_tpu.bsdf.planar import disney_evaluate_pdf as jeval
    from ti_raytrace_tpu.utils.sampling import map_to_disk as jdisk
    from ti_raytrace_tpu_torch.bsdf.planar import disney_evaluate_pdf
    from ti_raytrace_tpu_torch.utils.sampling import map_to_disk

    rng = np.random.default_rng(6)
    n, v, l = (rng.normal(size=(3, 4096)).astype(np.float32) for _ in range(3))
    n /= np.linalg.norm(n, axis=0)
    v /= np.linalg.norm(v, axis=0)
    l /= np.linalg.norm(l, axis=0)
    m, r = rng.random((2, 4096), np.float32)
    args = [torch.from_numpy(x) for x in (n, v, l, m, r)]
    pdfs = []
    for true_pdf in (True, False):
        want = jeval(*(jnp.asarray(x) for x in (n, v, l, m, r)), true_pdf=true_pdf)
        got = disney_evaluate_pdf(*args, true_pdf=true_pdf)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
        pdfs.append(got[1].numpy())
    valid = pdfs[1] >= 0.0
    assert valid.sum() > 500
    n_dot_l = (n * l).sum(axis=0)
    change = 0.5 * (1.0 - m) * (n_dot_l / np.pi - 1.0 / np.pi)
    np.testing.assert_allclose((pdfs[0] - pdfs[1])[valid], change[valid], rtol=1e-6,
                               atol=1e-6)
    assert (pdfs[0][~valid] == -1.0).all()
    u = rng.random((2, 4096), np.float32)
    u[:, :4] = 0.5  # the disk centre
    for a, b in zip(map_to_disk(*torch.from_numpy(u)), jdisk(*jnp.asarray(u))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_camera_raster_and_project_match_reference(scenes):  # noqa: F811
    from ti_raytrace_tpu.camera import project as jproject
    from ti_raytrace_tpu.camera import ray_directions as jdirs
    from ti_raytrace_tpu_torch.camera import project, ray_directions

    js, ts, jhost, _ = scenes
    (jspec, jcam), (tspec, tcam) = _cameras(js, ts, 48)
    for frame in (0, 3):
        want = np.asarray(jdirs(jspec, jcam, jnp.int32(frame), jax.random.PRNGKey(frame)))
        got = ray_directions(tspec, tcam, frame, _tkey(jax.random.PRNGKey(frame)))
        assert got.shape == want.shape == (48 * 48, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(7)
    lo, hi = jhost["aabb_min"], jhost["aabb_max"]
    p = (lo + rng.random((20000, 3)) * (hi - lo)).astype(np.float32)
    p[:50] = np.asarray(jcam.eye) + rng.normal(size=(50, 3)).astype(np.float32) * 1e-3
    ju, jv, jwi, jok = map(np.asarray, jproject(jspec, jcam, jnp.asarray(p)))
    tu, tv, twi, tok = (x.numpy() for x in project(tspec, tcam, torch.from_numpy(p)))
    assert jok.mean() > 0.2 and (~jok).sum() > 1000
    assert (tok == jok).mean() >= 0.999
    both = tok & jok
    assert ((tu == ju) & (tv == jv))[both].mean() >= 0.999
    np.testing.assert_allclose(twi, jwi, rtol=1e-6, atol=1e-6)


def _reference_subpaths(js, jspec, jcam, key, corrected=False, max_depth=2, compaction=None):
    """The reference's camera rays, keys and subpaths of one 16^2 frame."""
    k_eye, k_light, k_conn = jax.random.split(key, 3)
    k_cam, k_ewalk = jax.random.split(k_eye)
    from ti_raytrace_tpu.camera import ray_directions as jdirs

    o = jnp.broadcast_to(jcam.eye[:, None], (3, jspec.width * jspec.height))
    d = jnp.swapaxes(jdirs(jspec, jcam, jnp.int32(1), k_cam), 0, 1)
    fpdf0 = jbd._camera_dir_pdf(jspec, jcam, d) if corrected else None
    out = jbd.build_subpaths(js, o, d, k_ewalk, k_light, eye_depth=max_depth + 2,
                             light_depth=max_depth + 1, fpdf0=fpdf0, corrected=corrected,
                             walk_compaction=compaction, return_overflow=True)
    return (o, d, fpdf0, k_ewalk, k_light, k_conn), out


def _assert_verts_close(tv, tcount, jv, jcount):
    agree = tcount.numpy() == np.asarray(jcount)
    assert agree.mean() >= 0.999
    for depth, (a, b) in enumerate(zip(tv, jv)):
        for k in FLOAT_FIELDS:
            x, y = a[k].numpy()[..., agree], np.asarray(b[k])[..., agree]
            close = np.isclose(x, y, rtol=1e-5, atol=1e-5)
            assert close.reshape(-1, close.shape[-1]).all(axis=0).mean() >= 0.99, (depth, k)
            np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-5, err_msg=f"{depth} {k}")
        for k in INT_FIELDS:
            np.testing.assert_array_equal(a[k].numpy()[agree], np.asarray(b[k])[agree],
                                          err_msg=f"{depth} {k}")


@pytest.mark.parametrize("case", ["exact", "corrected", "compact"])
def test_build_subpaths_matches_reference(scenes, case):  # noqa: F811
    """16^2, max_depth 2 (eye walk 4 vertices, light walk 3), from the
    reference's camera rays and keys: the exact walk, the corrected one,
    and a compaction of both fronts before depth 2 (overflow equal)."""
    js, ts, _, _ = scenes
    (jspec, jcam), _ = _cameras(js, ts, 16)
    corrected = case == "corrected"
    sched = (((2, 2),), ((2, 2),)) if case == "compact" else None
    (o, d, fpdf0, k_ewalk, k_light, _), ref = _reference_subpaths(
        js, jspec, jcam, jax.random.PRNGKey(11), corrected, compaction=sched)
    port = tbd.build_subpaths(
        ts, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)), _tkey(k_ewalk),
        _tkey(k_light), eye_depth=4, light_depth=3,
        fpdf0=None if fpdf0 is None else torch.from_numpy(np.array(fpdf0)),
        corrected=corrected, walk_compaction=sched, return_overflow=True)
    assert int(port[4]) == int(ref[4])
    assert len(port[0]) == len(ref[0]) == 4 and len(port[2]) == len(ref[2]) == 3
    assert (np.asarray(ref[1]) >= 3).sum() > 50 and (np.asarray(ref[3]) >= 2).sum() > 50
    _assert_verts_close(port[0], port[1], ref[0], ref[1])
    _assert_verts_close(port[2], port[3], ref[2], ref[3])


def test_separate_walks_equal_fused(scenes):  # noqa: F811
    """The separate builders (build_eye_path, build_light_path, and _walk
    with a compaction schedule) give the fused build_subpaths' vertices
    exactly, with the same keys: a lane's hit does not depend on the
    wavefront it is traced in."""
    from ti_raytrace_tpu_torch.core import rng

    _, ts, _, _ = scenes
    _, (spec, cam) = _cameras(scenes[0], ts, 16)
    k_eye, k_light = rng.split(rng.PRNGKey(15))
    k_cam, k_walk = rng.split(k_eye)
    o, d = tbd._camera_rays(spec, cam, 1, k_cam)
    sched = ((2, 2),)
    fused = tbd.build_subpaths(ts, o, d, k_walk, k_light, eye_depth=4, light_depth=3,
                               walk_compaction=(sched, None), return_overflow=True)
    eye = tbd.build_eye_path(ts, spec, cam, 1, k_eye, eye_depth=4)
    light = tbd.build_light_path(ts, 256, k_light, light_depth=3)
    ones = torch.ones(256)
    walked = tbd._walk(ts, o, d, torch.ones(3, 256), ones, tbd._eye_vertex0(o, d), 4, k_walk,
                       is_light_path=False, compaction=sched)
    assert int(eye[2]) == int(light[2]) == 0 and int(walked[2]) == int(fused[4])
    for (verts, count), (want, want_count) in (
            ((light[0], light[1]), (fused[2], fused[3])),
            ((walked[0], walked[1]), (fused[0], fused[1]))):
        assert torch.equal(count, want_count)
        for a, b in zip(verts, want):
            for k in FLOAT_FIELDS + INT_FIELDS:
                assert torch.equal(a[k], b[k]), k
    assert torch.equal(eye[1], tbd.build_subpaths(ts, o, d, k_walk, k_light, 4, 3)[1])


def test_shadow_cap_counts_its_kills(scenes, monkeypatch):  # noqa: F811
    """With the sorted mode forced at 16^2 (SMALL_WAVEFRONT 0): the sorted
    render equals the unsorted one bit for bit (a lane's hit does not
    depend on its tile), a cap that covers the active lanes (0.7: 1,024
    of the batch's 1,280 lanes, 856 of them active) changes nothing, and a
    cap below them cuts shadow lanes and counts each one as overflow."""
    from ti_raytrace_tpu_torch.core import rng

    _, ts, _, _ = scenes
    _, (spec, cam) = _cameras(scenes[0], ts, 16)
    key = rng.PRNGKey(16)
    unsorted = tbd.render_paths(ts, spec, cam, 1, key, max_depth=2)
    monkeypatch.setattr(tct, "SMALL_WAVEFRONT", 0)
    outs = {cap: tbd.render_paths(ts, spec, cam, 1, key, max_depth=2, shadow_cap=cap,
                                  return_overflow=True) for cap in (None, 0.7, 0.05)}
    assert torch.equal(outs[None][0], unsorted) and int(outs[None][1]) == 0
    assert torch.equal(outs[0.7][0], unsorted) and int(outs[0.7][1]) == 0
    assert int(outs[0.05][1]) > 100
    assert outs[0.05][0].sum() < unsorted.sum()  # cut lanes read as occluded


def test_mis_weight_matches_reference():
    """Random vertex pools (a quarter of the pdfs zero: the remap; a
    fifth of the vertices delta) and random overrides, every (e, l) of
    MAX_DEPTH 5 and every override combination the strategies use."""
    rng = np.random.default_rng(12)
    n = 2048

    def pool(depth):
        out = []
        for _ in range(depth):
            v = {k: rng.exponential(size=n).astype(np.float32) for k in ("fpdf", "rpdf")}
            for k in ("fpdf", "rpdf"):
                v[k][rng.random(n) < 0.25] = 0.0
            v["delta"] = (rng.random(n) < 0.2).astype(np.float32)
            out.append(v)
        return out

    eye, light = pool(7), pool(6)
    ovs = {k: rng.exponential(size=n).astype(np.float32)
           for k in ("eye_rpdf_e1", "eye_rpdf_e2", "light_rpdf_l1", "light_rpdf_l2",
                     "sample_fpdf0")}
    jeye = [{k: jnp.asarray(v) for k, v in p.items()} for p in eye]
    jlight = [{k: jnp.asarray(v) for k, v in p.items()} for p in light]
    teye = [{k: torch.from_numpy(v) for k, v in p.items()} for p in eye]
    tlight = [{k: torch.from_numpy(v) for k, v in p.items()} for p in light]
    checked = 0
    for e in range(1, 8):
        for l in range(0, 7):
            if (e == 1 and l == 1) or not 2 <= e + l <= 7:
                continue
            for keys in (("eye_rpdf_e1", "eye_rpdf_e2"),
                         ("eye_rpdf_e1", "light_rpdf_l1", "sample_fpdf0", "eye_rpdf_e2"),
                         ("eye_rpdf_e1", "light_rpdf_l1", "eye_rpdf_e2", "light_rpdf_l2")):
                want = jbd._mis_weight(jeye, jlight, e, l, {k: jnp.asarray(ovs[k]) for k in keys})
                got = tbd._mis_weight(teye, tlight, e, l,
                                      {k: torch.from_numpy(ovs[k]) for k in keys})
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)
                checked += 1
    assert checked == 78


@pytest.mark.parametrize("case", ["reference", "corrected", "unweighted"])
def test_connections_match_reference(scenes, case):  # noqa: F811
    """Every strategy of max_depth 2 from the reference's subpaths of one
    16^2 frame: the radiance and the e=1 splat film, at the render bar,
    for both estimators and without MIS weights."""
    js, ts, _, _ = scenes
    (jspec, jcam), (tspec, tcam) = _cameras(js, ts, 16)
    corrected, unweighted = case == "corrected", case == "unweighted"
    (_, _, _, _, _, k_conn), (ev, ec, lv, lc, _) = _reference_subpaths(
        js, jspec, jcam, jax.random.PRNGKey(13), corrected)
    j_rad, j_splat = jbd._connections(js, jspec, jcam, ev, ec, lv, lc, k_conn,
                                      corrected=corrected, max_depth=2,
                                      unweighted=unweighted)
    t_rad, t_splat, kills = tbd._connections(
        ts, tspec, tcam, _tverts(ev), torch.from_numpy(np.array(ec)), _tverts(lv),
        torch.from_numpy(np.array(lc)), _tkey(k_conn), corrected=corrected, max_depth=2,
        unweighted=unweighted)
    assert int(kills) == 0
    for a, b, axis in ((t_rad.numpy(), np.asarray(j_rad), 0),
                       (t_splat.numpy(), np.asarray(j_splat), -1)):
        assert b.mean() > 1e-3 and (b > 0).any(axis=axis).sum() > 10
        assert np.isclose(a, b, rtol=1e-3, atol=0.0).all(axis=axis).mean() >= 0.98
        assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()


def test_splat_is_one_ordered_scatter_add():
    """Duplicate pixels accumulate in lane order, strategy after strategy,
    as the reference's successive scatter-adds; the deterministic-
    algorithms flag is restored after the call."""
    rng = np.random.default_rng(14)
    pix = rng.integers(0, 16, size=3000)
    vals = rng.normal(size=(3000, 3)).astype(np.float32) * 1e3
    want = jnp.zeros((4, 4, 3), jnp.float32)
    for part in np.array_split(np.arange(3000), 5):
        want = want.at[pix[part] // 4, pix[part] % 4].add(jnp.asarray(vals[part]))
    flat = torch.zeros(16, 3)
    before = torch.are_deterministic_algorithms_enabled()
    tbd._splat_add(flat, torch.from_numpy(pix), torch.from_numpy(vals))
    assert torch.are_deterministic_algorithms_enabled() == before
    np.testing.assert_array_equal(flat.reshape(4, 4, 3).numpy(), np.asarray(want))


def test_bdpt_rgb_smoke(scenes):  # noqa: F811
    """Port of the reference's slow smoke test, on Veach: one full-depth
    frame is a finite, non-negative, non-black image."""
    _, ts, _, _ = scenes
    _, (spec, cam) = _cameras(scenes[0], ts, 16)
    img, overflow = tbd.render_frame(ts, spec, cam, 1, _tkey(jax.random.PRNGKey(2)),
                                     return_overflow=True)
    img = img.numpy()
    assert img.shape == (16, 16, 3) and int(overflow) == 0
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() > 0.0


def test_bdpt_sliced_consistent(scenes):  # noqa: F811
    """Port of the reference's slow slicing test, on Veach: sliced frames
    have the magnitude of unsliced ones (the slices draw other random
    numbers, so statistics only)."""
    from ti_raytrace_tpu_torch.core import rng

    _, ts, _, _ = scenes
    _, (spec, cam) = _cameras(scenes[0], ts, 16)
    k = rng.PRNGKey(9)
    full = np.zeros((16, 16, 3), np.float32)
    sliced = np.zeros((16, 16, 3), np.float32)
    for i in range(6):
        kk = rng.fold_in(k, i)
        full += tbd.render_frame(ts, spec, cam, 1, kk, max_depth=3).numpy()
        sliced += tbd.render_frame_sliced(ts, spec, cam, 1, kk, 2, max_depth=3).numpy()
    full /= 6
    sliced /= 6
    assert np.isfinite(sliced).all() and sliced.min() >= 0.0
    assert abs(sliced.mean() - full.mean()) / full.mean() < 0.15


def test_cli_and_golden_render_veach_bdpt(tmp_path, capsys):
    """`run veach_bdpt` (its own integrator, BDPT) on the CPU writes a PNG
    with 0 walk overflow; the golden gate runs the veach_bdpt target and
    reports its diff against the reference's bound."""
    import json

    from ti_raytrace_tpu_torch.examples import run
    from ti_raytrace_tpu_torch.tools import golden

    out = tmp_path / "veach-bdpt.png"
    run.main(["veach_bdpt", "--size", "8", "--frames", "2", "--device", "cpu",
              "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["integrator"] == "bdpt_rgb" and line["frames"] == 2
    assert line["overflow_kills"] == 0 and line["batch"] == 4
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rc = golden.main(["--scene", "veach_bdpt", "--size", "8", "--frames", "1",
                      "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["scene"] == "veach_bdpt" and line["bound"] == 0.0804
    assert rc == (0 if line["diff"] <= line["bound"] else 1) and line["diff"] > 0.0
