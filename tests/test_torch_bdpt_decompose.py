"""The port's BDPT strategy decomposition
(ti_raytrace_tpu_torch/tools/bdpt_decompose.py) against the JAX package's
on the CPU, on the Veach scene at 16^2 (test_torch_nee.py's fixture).

The reference's tool switches its package to the dense sweep when it runs
on the CPU (`accel.DENSE_MAX_PRIMS = 10**9` in its `main`); the tests do
the same for the reference, whose Pallas kernel would otherwise run in
interpret mode 31 times per frame.  The port keeps its dispatch (the
cluster tracer's plain version); the two tracers agree up to t-ties.
Tolerances, with their reasons:
  * the diagnostic box's host dict: byte-equal (both builds are numpy);
  * per-strategy means of one 16^2 frame: within 2% of the reference's, or
    within 2e-3 of the frame's total (256 paths per strategy: an ulp that
    flips one occlusion or MIS decision moves a strategy's mean by up to
    one path's share of it);
  * the strategies' sum against the port's own `render_paths` from the
    same subpaths: rtol 1e-5 (26 means summed in another order).
"""

import numpy as np
import pytest
import torch

from test_torch_nee import _cameras, scenes  # noqa: F401  (fixture)
from ti_raytrace_tpu.tools import bdpt_decompose as jdec
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import bdpt_rgb as tbd
from ti_raytrace_tpu_torch.tools import bdpt_decompose as tdec

torch.set_num_threads(2)


@pytest.fixture()
def reference_on_dense_sweep(monkeypatch):
    import ti_raytrace_tpu.accel as jaccel

    monkeypatch.setattr(jaccel, "DENSE_MAX_PRIMS", 10 ** 9)


def test_diag_box_matches_reference():
    from ti_raytrace_tpu.examples.scenes import framing_params as jframing
    from ti_raytrace_tpu.scene.build import SceneBuilder as JBuilder
    from ti_raytrace_tpu.scene.data import device_scene as jdevice
    from ti_raytrace_tpu_torch.examples.scenes import framing_params

    captured = {}
    real_build = JBuilder.build

    def build(self, smooth_normals=False, spectral=False):
        captured["host"] = self.build_host(smooth_normals, spectral)
        return jdevice(captured["host"])

    JBuilder.build = build
    try:
        js, jcfg = jdec._diag_box()
    finally:
        JBuilder.build = real_build
    jhost, thost = captured["host"], tdec._diag_box_host()
    ref_keys = {k for k in jhost if k != "cluster_mt"}
    assert set(thost) == ref_keys
    for k in sorted(ref_keys):
        a, b = np.asarray(thost[k]), np.asarray(jhost[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    ts, tcfg = tdec._diag_box("cpu")
    assert ts.n_prims == js.n_prims == 14 and ts.n_lights == 2
    assert ts.mat_type.shape == (2,)
    for a, b in zip(framing_params(ts, tcfg), jframing(js, jcfg)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", ["reference", "unweighted"])
def test_strategy_decomposition_matches_reference(scenes, reference_on_dense_sweep,  # noqa: F811
                                                  case):
    js, ts, _, _ = scenes
    (jspec, jcam), (tspec, tcam) = _cameras(js, ts, 16)
    unweighted = case == "unweighted"
    want = jdec.bdpt_strategy_decomposition(js, jspec, jcam, 1, unweighted=unweighted)
    got = tdec.bdpt_strategy_decomposition(ts, tspec, tcam, 1, unweighted=unweighted)
    assert list(got) == list(want) == tdec.strategy_pairs() and len(got) == 26
    total = sum(want.values())
    assert total > 0.05 and sum(v > 0 for v in want.values()) >= 15
    for pair, v in want.items():
        assert abs(got[pair] - v) <= max(0.02 * abs(v), 2e-3 * total), (pair, got[pair], v)
    assert abs(sum(got.values()) - total) <= 0.01 * total


def test_strategy_sum_is_the_frame(scenes):  # noqa: F811
    """The 26 single-strategy means of a frame add up to the mean of the
    frame that `_connections` gives from the same subpaths and keys."""
    _, ts, _, _ = scenes
    _, (spec, cam) = _cameras(scenes[0], ts, 16)
    strat = tdec.bdpt_strategy_decomposition(ts, spec, cam, 1)
    k_eye, k_light, k_conn = rng.split(rng.PRNGKey(100), 3)
    eye, ec, _ = tbd.build_eye_path(ts, spec, cam, 1, k_eye)
    light, lc, _ = tbd.build_light_path(ts, 256, k_light)
    rad, splat, _ = tbd._connections(ts, spec, cam, eye, ec, light, lc, k_conn)
    frame_mean = float(rad.mean() + splat.mean())
    assert frame_mean > 0.05
    np.testing.assert_allclose(sum(strat.values()), frame_mean, rtol=1e-5)


def test_pt_depth_decomposition_matches_reference(scenes, reference_on_dense_sweep):  # noqa: F811
    """Successive truncations of the path tracer at 8^2: the per-depth
    means add up to the deepest truncation, and follow the reference's
    (2% of the total: 64 paths, an ulp flips one now and then)."""
    js, ts, _, _ = scenes
    (jspec, jcam), (tspec, tcam) = _cameras(js, ts, 8)
    jt, jper = jdec.pt_depth_decomposition(js, jspec, jcam, 1, nee=True)
    tt, tper = tdec.pt_depth_decomposition(ts, tspec, tcam, 1, nee=True)
    assert len(tper) == len(jper) == 8 and tt > 0.01
    np.testing.assert_allclose(sum(tper), tt, rtol=1e-5)
    np.testing.assert_allclose(tt, jt, rtol=0.02)
    np.testing.assert_allclose(tper, jper, rtol=0.0, atol=0.02 * jt)


@pytest.mark.parametrize("argv", [
    ["--scene", "prism_rainbow", "--spectral"],
    ["--scene", "diagbox", "--corrected"],
])
def test_cli_runs(argv, capsys):
    """The CLI on the CPU at 8^2: the spectral decomposition of prism (no
    PT truth) and the corrected one of the diagnostic box, where BDPT's
    depth totals are printed beside PT's."""
    tdec.main(argv + ["--size", "8", "--frames", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(e, l) strategy means:" in out and out.count("  e=") == 26
    if "--spectral" in argv:
        assert "(SPECTRAL)" in out and "spectral BDPT total mean:" in out
        total = float(out.split("spectral BDPT total mean:")[1].split()[0])
        assert np.isfinite(total) and total > 0.0
    else:
        assert "edges | PT(noNEE) |     BDPT | ratio" in out and "(corrected)" in out
        ratio = float(out.split("(ratio ")[1].split(")")[0])
        assert 0.3 < ratio < 3.0
