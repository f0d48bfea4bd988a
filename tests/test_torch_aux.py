"""The port's auxiliary modules against the JAX package on the CPU: the
render meter (metrics.py) and the CLI's report of it, the rgb2spec fit
(spectral/jakob_fit.py) and the table helpers of spectral/rgb2spec.py,
the utility twins (sampling, colour spaces, microfacets, the solar disc,
the hero one-hot), and the rule that the port's entry points default to
the card.

Tolerances: host numpy (the fit, Planck, the matrices, the solar disc)
bit-equal or 1e-10 for the fit; f32 tensor math atol 1e-6 (XLA fuses
multiply-adds on the CPU, the port rounds every product); the meter's
arithmetic equal.
"""

import importlib
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=atol)


# ------------------------------------------------------------------ meter

def test_metrics_meter():
    """The reference's meter test (tests/test_io_texture.py) on the port,
    and the port's report equal to the reference's for one tick stream."""
    from ti_raytrace_tpu.metrics import RenderMeter as JMeter
    from ti_raytrace_tpu_torch.metrics import RenderMeter

    m = RenderMeter(512 * 512)
    m.tick(10.0)  # warm-up (kernel builds)
    for _ in range(5):
        m.tick(0.1)
    assert abs(m.fps - 10.0) < 1e-6
    rep = m.report()
    assert rep["frames"] == 5 and rep["compile_s"] == 10.0
    assert abs(rep["mrays_per_s"] - 512 * 512 * 10 / 1e6) < 1e-3

    a, b = RenderMeter(64 * 48, 2.5), JMeter(64 * 48, 2.5)
    for s, n in ((3.2, 16), (0.41, 16), (0.37, 8), (0.123, 3)):
        a.tick(s, n)
        b.tick(s, n)
    assert a.report() == b.report() and a.summary() == b.summary()


def test_profile_trace_and_timed(tmp_path):
    from ti_raytrace_tpu_torch.metrics import profile_trace, timed

    lines = []
    with timed("block", sink=lines.append):
        with profile_trace(str(tmp_path)) as prof:
            torch.ones(64).cumsum(0)
    assert any("cumsum" in e.key for e in prof.key_averages())
    assert len(list(tmp_path.glob("trace-*.json"))) == 1
    assert len(lines) == 1 and lines[0].startswith("block: ")


def test_cli_json_line_carries_the_meter(tmp_path, capsys):
    from ti_raytrace_tpu_torch.examples import run

    run.main(["cornell_box", "--size", "8", "--frames", "3", "--snapshot-every", "1",
              "--device", "cpu", "--out", str(tmp_path / "c.png")])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("fps", "spp_per_s", "mrays_per_s", "avg_frame_ms", "compile_s",
              "warmup_ms_per_frame", "ms_per_frame", "overflow_kills"):
        assert k in rep, k
    assert rep["frames"] == 3 and rep["fps"] > 0.0 and rep["compile_s"] > 0.0
    # one frame a dispatch; the warm-up is the first dispatch in both figures
    assert rep["compile_s"] == pytest.approx(rep["warmup_ms_per_frame"] / 1e3, abs=1e-3)
    assert rep["avg_frame_ms"] == pytest.approx(rep["ms_per_frame"], abs=1e-3)


# --------------------------------------------------------------- rgb2spec

def test_fit_table_matches_reference():
    from ti_raytrace_tpu.spectral import jakob_fit as jfit
    from ti_raytrace_tpu_torch.spectral import jakob_fit as tfit

    got, want = tfit.fit_table(res=5, iters=6), jfit.fit_table(res=5, iters=6)
    assert got.res == want.res == 5 and got.scale.tobytes() == want.scale.tobytes()
    np.testing.assert_allclose(got.data, want.data, rtol=0.0, atol=1e-10)
    integ = tfit._Integrator()
    rgb = np.random.default_rng(0).random((20, 3)) * 0.8 + 0.1
    lab, jac = tfit._lab(rgb, integ)
    jlab, jjac = jfit._lab(rgb, jfit._Integrator())
    np.testing.assert_allclose(lab, jlab, atol=1e-10)
    np.testing.assert_allclose(jac, jjac, atol=1e-10)
    cn = np.random.default_rng(1).normal(size=(7, 3))
    assert tfit._to_nm_units(cn).tobytes() == jfit._to_nm_units(cn).tobytes()
    for k in range(3):
        t = tfit._lattice_targets(k, 2, 5, got.scale)
        assert t.tobytes() == jfit._lattice_targets(k, 2, 5, want.scale).tobytes()


def test_load_table_fits_a_missing_table(tmp_path, monkeypatch):
    """A missing table is fitted (here at res 4) and written, then read
    back; generate=False raises instead."""
    from ti_raytrace_tpu.spectral.jakob_fit import fit_table as jfit
    from ti_raytrace_tpu_torch.spectral import rgb2spec

    monkeypatch.setattr(rgb2spec, "RES", 4)
    path = str(tmp_path / "sub" / "spec_table.npz")
    with pytest.raises(FileNotFoundError, match="spec_table"):
        rgb2spec.load_table(path, generate=False)
    fitted = rgb2spec.load_table(path)
    again = rgb2spec.load_table(path, generate=False)
    assert fitted.data.tobytes() == again.data.tobytes() and again.res == 4
    np.testing.assert_allclose(again.data, jfit(4).data, rtol=0.0, atol=1e-10)


def test_rgb2spec_helpers_match_reference(tmp_path):
    from ti_raytrace_tpu.spectral import rgb2spec as jr
    from ti_raytrace_tpu_torch.spectral import rgb2spec as tr

    x = np.linspace(0.0, 1.0, 11)
    assert tr.smoothstep(x).tobytes() == jr.smoothstep(x).tobytes()
    assert tr.scale_lattice(64).tobytes() == jr.scale_lattice(64).tobytes()
    rng = np.random.default_rng(2)
    c = (rng.normal(size=(3, 50)) * [[1e-4], [1e-1], [5.0]]).astype(np.float32)
    lam = rng.uniform(360, 760, (4, 50)).astype(np.float32)
    _close(tr.eval_hero(*torch.from_numpy(c), torch.from_numpy(lam)),
           jr.eval_hero(*jnp.asarray(c), jnp.asarray(lam)))
    # the original renderer's text format: res, res scale lines, res^3 * 3 lines of 9
    res = 2
    data = rng.normal(size=(3, res, res, res, 3))
    path = tmp_path / "spec_table.txt"
    with open(path, "w") as f:
        f.write(f"{res}\n" + "".join(f"{float(s)!r}\n" for s in jr.scale_lattice(res)))
        for row in data.reshape(-1, 9):
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    got, want = tr.load_reference_format(str(path)), jr.load_reference_format(str(path))
    assert got.res == want.res == res and got.data.tobytes() == want.data.tobytes()
    assert got.scale.tobytes() == want.scale.tobytes()


# -------------------------------------------------------------- utilities

def _uniforms(n=300, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.random((2, n)).astype(np.float32)
    u[:, 0] = 0.0
    return u, torch.from_numpy(u)


def test_sampling_twins_match_reference():
    from ti_raytrace_tpu.utils import sampling as js
    from ti_raytrace_tpu_torch.utils import sampling as ts

    u, tu = _uniforms()
    _close(ts.cosine_hemisphere_pdf(tu[0] - 0.5), js.cosine_hemisphere_pdf(u[0] - 0.5))
    _close(ts.cosine_sample_hemisphere(*tu), js.cosine_sample_hemisphere(*u))
    p, pdf = ts.cosine_sample_hemisphere_pdf(*tu)
    jp, jpdf = js.cosine_sample_hemisphere_pdf(*u)
    _close(p, jp)
    _close(pdf, jpdf)
    _close(ts.uniform_sample_sphere(*tu), js.uniform_sample_sphere(*u))
    n = np.random.default_rng(5).normal(size=(300, 3)).astype(np.float32)
    n[0] = (1.0, 0.0, 0.0)
    n[1] = (0.0, 0.0, -2.0)
    for a, b in zip(ts.onb(torch.from_numpy(n)), js.onb(n)):
        _close(a, b)
    local = np.array(js.cosine_sample_hemisphere(*u))
    _close(ts.to_world(torch.from_numpy(local), torch.from_numpy(n)), js.to_world(local, n))


def test_colour_twins_match_reference():
    from ti_raytrace_tpu.utils import colorsp as jc
    from ti_raytrace_tpu_torch.utils import colorsp as tc

    xyz = np.random.default_rng(1).random((200, 3)).astype(np.float32)
    xyz[0] = 0.0
    t = torch.from_numpy(xyz)
    _close(tc.xyz_to_Yxy(t), jc.xyz_to_Yxy(xyz))
    yxy = np.asarray(jc.xyz_to_Yxy(xyz))
    _close(tc.Yxy_to_xyz(torch.from_numpy(yxy)), jc.Yxy_to_xyz(yxy))
    _close(tc.srgb_to_xyz(t), jc.srgb_to_xyz(xyz))
    _close(tc.xyz_to_srgb(t), jc.xyz_to_srgb(xyz))
    lam = np.linspace(360.0, 760.0, 81)
    for temp in (1800.0, 6504.0):
        assert tc.planck(lam, temp).tobytes() == jc.planck(lam, temp).tobytes()
    prim = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06), (0.9505, 1.0, 1.089))
    assert tc.calc_matr_rgb_to_xyz(*prim).tobytes() == jc.calc_matr_rgb_to_xyz(*prim).tobytes()


def test_microfacet_and_hero_twins_match_reference():
    from ti_raytrace_tpu.spectral import spd as jspd
    from ti_raytrace_tpu.utils import microfacet as jm
    from ti_raytrace_tpu_torch.spectral import spd as tspd
    from ti_raytrace_tpu_torch.utils import microfacet as tm

    u, tu = _uniforms(seed=3)
    alpha = np.linspace(0.05, 1.2, u.shape[1]).astype(np.float32)
    _close(tm.gtr1(tu[0], torch.from_numpy(alpha)), jm.gtr1(u[0], alpha), atol=1e-5)
    _close(tm.sample_gtr2_half(*tu, torch.from_numpy(alpha)), jm.sample_gtr2_half(*u, alpha))
    h = tspd.hero_onehot(tu[0])
    assert h.shape == (tspd.HERO_BINS, u.shape[1]) and h.dtype == torch.float32
    np.testing.assert_array_equal(h.numpy(), np.asarray(jspd.hero_onehot(jnp.asarray(u[0]))))


def test_solar_disc_matches_reference():
    from ti_raytrace_tpu.sky import hosek as jh
    from ti_raytrace_tpu_torch.sky import hosek as th

    for turb, elev in ((3.0, 0.17), (10.0, 0.9)):
        js, ts = jh.build_sky(turb, 0.5, elev), th.build_sky(turb, 0.5, elev)
        for lam in (330.0, 455.5, 719.0):
            for gamma in (0.0, 0.002, 0.1):
                got = th.solar_disc_radiance_np(ts, lam, elev, gamma)
                want = jh.solar_disc_radiance_np(js, lam, elev, gamma)
                assert np.float64(got).tobytes() == np.float64(want).tobytes()
    assert th.solar_disc_radiance_np(ts, 500.0, 0.9, 0.0) > 0.0


# -------------------------------------------------------- device defaults

CUDA_DEFAULTS = {
    "ti_raytrace_tpu_torch.examples.scenes": (
        "benchmark_100k", "veach_bdpt", "cornell_box", "single_model", "sky_dome",
        "spectral_box", "prism_rainbow"),
    "ti_raytrace_tpu_torch.scene.data": ("device_scene",),
    "ti_raytrace_tpu_torch.film": ("new_film", "load_checkpoint"),
    "ti_raytrace_tpu_torch.integrators.bdpt_spec": ("make_spec_ctx_fn", "make_render_frame"),
    "ti_raytrace_tpu_torch.integrators.pt_spec": ("make_spectral_data", "make_render_frame"),
    "ti_raytrace_tpu_torch.tools.bdpt_decompose": ("_diag_box",),
    "ti_raytrace_tpu_torch.camera": ("orbit_camera",),
    "ti_raytrace_tpu_torch.accel.lbvh": ("build_bvh",),
}


@pytest.mark.parametrize("module", sorted(CUDA_DEFAULTS))
def test_entry_points_default_to_the_card(module):
    """A library caller who names no device lands on the card."""
    mod = importlib.import_module(module)
    for name in CUDA_DEFAULTS[module]:
        default = inspect.signature(getattr(mod, name)).parameters["device"].default
        assert default == "cuda", f"{module}.{name} defaults to {default!r}"
