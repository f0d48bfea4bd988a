"""The four path-traced scenes of the dense tracer (cornell_box,
single_model, sky_dome, spectral_box) in the port against the JAX package
on the CPU: host dicts, whole pt_rgb renders, compaction calibration, the
debug AOVs and the CLI.  The spectral renders are in test_torch_spectral.py.

Tolerances, with their reasons:
  * host dicts: byte-equal (both host builds are numpy), minus the keys only
    the reference reads (`bvh_*`, `cluster_mt`);
  * 16^2 renders: >= 98% of pixels within rtol 1e-3 and image means
    within 1% (XLA fuses multiply-adds, the port does not; an ulp flips a
    discrete decision now and then and with it a whole path), the bar of
    test_torch_pt_rgb.py;
  * merged group=1 against the port's sequential loop: rtol 1e-5 (same
    key chain, same phases);
  * debug AOVs: atol 1e-5 on >= 99.5% of pixels (a camera ray grazing an
    edge may pick the neighbouring triangle), prim ids equal on the same.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_trace import cameras, reference_and_port
from ti_raytrace_tpu.integrators import pt_rgb as jpt
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import pt_rgb as tpt

torch.set_num_threads(2)

SCENES = ["cornell_box", "single_model", "sky_dome", "spectral_box"]


@pytest.mark.parametrize("name", SCENES)
def test_host_dict_matches_reference(name):
    """The port's host dict against the reference's (spectral pack rows
    included), and the device scene from either."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    js, jcfg, jhost, ts, tcfg, thost = reference_and_port(name)
    ref_keys = {k for k in jhost if not k.startswith("bvh_") and k != "cluster_mt"}
    assert set(thost) == ref_keys
    for k in sorted(ref_keys):
        a, b = np.asarray(thost[k]), np.asarray(jhost[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    spectral = name in ("sky_dome", "spectral_box")
    assert bool(thost["prim_attr"][32:40].any()) == spectral
    assert bool(thost["light_attr"][32:36].any()) == spectral
    if name == "spectral_box":
        assert set(np.unique(thost["prim_attr"][39])) == {-1.0, 0.0, 1.0, 2.0}

    from_ref = device_scene(jhost, "cpu")
    for f in ts.__dataclass_fields__:
        a, b = getattr(ts, f), getattr(from_ref, f)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f
    assert ts.n_prims == js.n_prims and ts.n_lights == js.n_lights
    for f in ("name", "integrator", "scale_mult", "exposure", "sky", "compaction", "group",
              "batch", "bdpt_walk_compaction", "bdpt_shadow_cap"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def _assert_render_close(a, b, min_mean=0.01):
    assert a.shape == b.shape and np.isfinite(a).all()
    assert b.mean() > min_mean
    assert np.isclose(a, b, rtol=1e-3, atol=0.0).all(axis=-1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()


def test_cornell_render_matches_reference():
    """16^2 cornell_box, `render_frame` with the scene's own schedule (four
    compactions) and NEE, the full depth of 15."""
    js, jcfg, _, ts, tcfg, _ = reference_and_port("cornell_box")
    (jspec, jcam), (tspec, tcam) = cameras("cornell_box", 16)
    assert tpt.has_nee_materials(ts) and jpt.has_nee_materials(js)
    want = jpt.render_frame(js, jspec, jcam, jnp.int32(1), jax.random.PRNGKey(3),
                            compaction=jcfg.compaction, nee=True)
    got = tpt.render_frame(ts, tspec, tcam, 1, rng.PRNGKey(3), compaction=tcfg.compaction,
                           nee=True)
    _assert_render_close(got.numpy(), np.asarray(want))


def test_single_model_merged_matches_sequential_and_reference():
    """16^2 single_model with its schedule ((1,4),(3,128)): merged group=1
    equals the sequential loop; a merged group of 2 matches JAX."""
    from ti_raytrace_tpu import film as jfilm
    from ti_raytrace_tpu_torch import film as tfilm

    js, jcfg, _, ts, tcfg, _ = reference_and_port("single_model")
    (jspec, jcam), (tspec, tcam) = cameras("single_model", 16)
    sched = tcfg.compaction
    assert not tpt.has_nee_materials(ts) and sched == jcfg.compaction
    fm, ovm = tpt.render_film_frames_merged(ts, tspec, tcam, tfilm.new_film(16, 16, seed=13),
                                            2, 1, sched, max_depth=6)
    fs, ovs = tpt.render_film_frames(ts, tspec, tcam, tfilm.new_film(16, 16, seed=13),
                                     2, sched, max_depth=6)
    assert fm.frame == fs.frame == 2 and ovm == ovs == 0
    np.testing.assert_array_equal(fm.key.numpy(), fs.key.numpy())
    np.testing.assert_allclose(fm.hdr.numpy(), fs.hdr.numpy(), rtol=1e-5, atol=1e-6)

    jf, jov = jpt.render_film_frames_merged(js, jspec, jcam, jfilm.new_film(16, 16, seed=5),
                                            2, 2, sched, False, max_depth=6)
    tf, tov = tpt.render_film_frames_merged(ts, tspec, tcam, tfilm.new_film(16, 16, seed=5),
                                            2, 2, sched, False, max_depth=6)
    assert tf.frame == int(jf.frame) == 2 and tov == int(jov) == 0
    _assert_render_close(tf.hdr.numpy(), np.asarray(jf.hdr))


def test_calibrate_compaction_matches_reference():
    """The probe-frame schedule of the glass scene: paths die early, so a
    non-trivial schedule, and the reference's own."""
    js, _, _, ts, _, _ = reference_and_port("single_model")
    (jspec, jcam), (tspec, tcam) = cameras("single_model", 32)
    sched = tpt.calibrate_compaction(ts, tspec, tcam, probe_size=32)
    assert sched is not None and len(sched) >= 1
    starts, divs = [s for s, _ in sched], [d for _, d in sched]
    assert starts == sorted(starts)
    assert all(d2 >= 2 * d1 for d1, d2 in zip(divs, divs[1:]))
    assert sched == jpt.calibrate_compaction(js, jspec, jcam, probe_size=32)
    # a closed diffuse box keeps its occupancy: no schedule
    box = reference_and_port("cornell_box")[3]
    _, (bspec, bcam) = cameras("cornell_box", 32)
    assert tpt.calibrate_compaction(box, bspec, bcam, probe_size=16, max_depth=4) is None


@pytest.mark.parametrize("aov", ["albedo", "normal", "gnormal", "fnormal", "depth", "prim"])
def test_debug_aov_matches_reference(aov):
    from ti_raytrace_tpu.integrators import debug as jdebug
    from ti_raytrace_tpu_torch.integrators import debug as tdebug

    js, _, _, ts, _, _ = reference_and_port("single_model")
    (jspec, jcam), (tspec, tcam) = cameras("single_model", 32)
    want = np.asarray(jdebug.render_frame(js, jspec, jcam, 1, jax.random.PRNGKey(0), aov=aov))
    got = tdebug.render_frame(ts, tspec, tcam, 1, rng.PRNGKey(0), aov=aov).numpy()
    assert got.shape == want.shape == (32, 32, 3) and np.isfinite(got).all()
    assert (want != 0).any(axis=-1).mean() > 0.1  # the sphere is in frame
    assert np.isclose(got, want, rtol=0.0, atol=1e-5).all(axis=-1).mean() >= 0.995
    with pytest.raises(ValueError, match="unknown aov"):
        tdebug.render_frame(ts, tspec, tcam, 1, rng.PRNGKey(0), aov="nope")
    assert aov in tdebug.AOVS and len(tdebug.AOVS) == 6


@pytest.mark.parametrize("name", SCENES)
def test_cli_renders_scene_and_resumes_checkpoint(name, tmp_path, capsys):
    """`run <scene>` on the CPU at 16^2 with the scene's own integrator:
    4 frames straight, and 2 + 2 frames through --checkpoint, give the same
    checkpointed film (same key chain, same frame count)."""
    from ti_raytrace_tpu_torch import film as tfilm
    from ti_raytrace_tpu_torch.examples import run

    def cli(frames, ckpt, png):
        run.main([name, "--size", "16", "--frames", str(frames), "--device", "cpu",
                  "--out", str(tmp_path / png), "--checkpoint", str(tmp_path / ckpt),
                  "--snapshot-every", "2"])
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    line = cli(4, "straight.npz", "a.png")
    assert line["scene"] == name and line["frames"] == 4 and line["overflow_kills"] == 0
    assert line["integrator"] == ("pt_spec" if name in ("sky_dome", "spectral_box") else "pt_rgb")
    assert (tmp_path / "a.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert cli(2, "halves.npz", "b.png")["frames"] == 2
    assert cli(4, "halves.npz", "b.png")["frames"] == 4
    a = tfilm.load_checkpoint(str(tmp_path / "straight.npz"))
    b = tfilm.load_checkpoint(str(tmp_path / "halves.npz"))
    assert a.frame == b.frame == 4 and torch.equal(a.key, b.key)
    assert float(a.hdr.mean()) > 0.01
    np.testing.assert_allclose(b.hdr.numpy(), a.hdr.numpy(), rtol=1e-6, atol=1e-7)


def test_cli_debug_and_unported(tmp_path, capsys):
    """Every scene of the reference is a CLI scene now: prism_rainbow
    renders with its own integrator, the spectral BDPT.  A scene built
    without the spectral pack rows renders black under `--integrator
    bdpt_spec`, as the reference does there (checked by running it at 8^2:
    its emitters carry no power in the zero rows); an unknown scene or
    integrator is a ValueError."""
    from ti_raytrace_tpu_torch import film as tfilm
    from ti_raytrace_tpu_torch.examples import run
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES

    assert sorted(EXAMPLES) == ["benchmark_100k", "cornell_box", "prism_rainbow",
                                "single_model", "sky_dome", "spectral_box", "veach_bdpt"]

    def cli(*argv):
        run.main(list(argv) + ["--size", "8", "--frames", "2", "--device", "cpu", "--out",
                               str(tmp_path / "o.png"), "--checkpoint", str(tmp_path / "c.npz")])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        fl = tfilm.load_checkpoint(str(tmp_path / "c.npz"))
        (tmp_path / "c.npz").unlink()
        return line, fl

    line, fl = cli("prism_rainbow")
    assert line["scene"] == "prism_rainbow" and line["integrator"] == "bdpt_spec"
    assert line["frames"] == fl.frame == 2 and line["batch"] == 4 and line["overflow_kills"] == 0
    assert bool(torch.isfinite(fl.hdr).all()) and float(fl.hdr.mean()) > 0.0
    assert (tmp_path / "o.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    line, fl = cli("cornell_box", "--integrator", "bdpt_spec")
    assert line["integrator"] == "bdpt_spec" and line["overflow_kills"] == 0
    assert fl.frame == 2 and not bool(fl.hdr.any())
    with pytest.raises(ValueError, match="unknown scene"):
        run.main(["rainbow", "--size", "8", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown integrator"):
        run.main(["cornell_box", "--integrator", "bdpt", "--size", "8", "--device", "cpu"])


def test_cli_debug_integrator(tmp_path, capsys):
    from ti_raytrace_tpu_torch.examples import run

    run.main(["cornell_box", "--integrator", "debug", "--size", "16", "--frames", "2",
              "--device", "cpu", "--out", str(tmp_path / "d.png")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["integrator"] == "debug" and line["frames"] == 2 and line["batch"] == 1
    assert (tmp_path / "d.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
