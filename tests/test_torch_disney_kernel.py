"""The Disney BSDF kernels (ti_raytrace_tpu_torch/csrc/disney.cu over
disney.cuh) and what surrounds them in bsdf/planar.py: the dispatchers
`disney_evaluate_pdf` and `disney_sample`, the wrapper (`DISNEY_KERNEL`),
the plain twins `disney_evaluate_pdf_plain` and `disney_sample_plain`,
the `bsdf.disney` span and the benchmark's reader of it
(`bsdf_kernel.route_share`).

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_disney_kernel.py -m gpu --noconftest -p no:cacheprovider

The CPU cases hold the plain route to the pre-change functions (the
benchmark's frozen copy, `benchmark/reference/plain/bsdf/planar.py`) bit
for bit, check that every call site of the integrators goes through the
dispatcher with shapes the kernel takes, that the wrapper's checks raise,
and that a BDPT and a PT+NEE frame keep their film and their torch calls.
The `gpu` cases launch the kernels and hold them against the plain twins
on the card bit for bit (NaN-aware on the int32 views: the kernels repeat
the twins' float32 operations in ATen's order, so there is no tolerance),
and each cell's path against the same call with the plain route forced.
"""

import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch import film, metrics
from ti_raytrace_tpu_torch.bsdf import planar
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.examples import scenes
from ti_raytrace_tpu_torch.examples.run import render_batch, spectral_data
from ti_raytrace_tpu_torch.integrators import bdpt_rgb, bdpt_spec, pt_rgb
from ti_raytrace_tpu_torch.ops import cuda_build
from ti_raytrace_tpu_torch.tools.profile_bdpt import count_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import program, registry  # noqa: E402
from harness import spans as bench_spans  # noqa: E402
from reference import render as ref_render  # noqa: E402
from reference.plain import film as ref_film  # noqa: E402
from reference.plain.bsdf import planar as frozen  # noqa: E402  (the pre-change functions)

torch.set_num_threads(2)

CELLS = [w["name"] for w in registry.spec()["workloads"]]
INTEGRATORS = os.path.join(REPO, "ti_raytrace_tpu_torch", "integrators")
SITE_FILES = ("pt_rgb.py", "bdpt_rgb.py", "pt_spec.py", "bdpt_spec.py")
CALL = re.compile(r"(?<![\w.])(disney_evaluate_pdf|disney_sample|_disney_pdf|_evaluate_pdf)\(")
BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def fresh():
    metrics.clear_spans()
    planar.DISNEY_KERNEL.reset_counts()
    yield
    metrics.clear_spans()


def _unit(gen, n):
    v = gen.standard_normal((3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def eval_inputs(n=None, seed=0):
    """(n, v, l, metallic, roughness) as float32 numpy arrays: the edge
    lanes below, then random ones up to n lanes (n may be less than the
    edge lanes: they are cut; None: the edge lanes alone)."""
    gen = np.random.default_rng(seed)
    cols = []  # (n, v, l, metallic, roughness) per lane
    z = np.array([0.0, 0.0, 1.0], np.float32)
    up = np.array([0.3, 0.2, 0.9], np.float32) / np.linalg.norm([0.3, 0.2, 0.9])
    side = np.array([1.0, 0.0, 0.0], np.float32)
    v0 = np.array([0.4, -0.3, 0.8], np.float32) / np.linalg.norm([0.4, -0.3, 0.8])
    for m, r in ((0.0, 0.0), (1.0, 0.0), (0.5, 0.001), (0.2, 1e-4), (0.7, 1.0), (0.0, 0.5)):
        cols += [
            (z, v0, up, m, r),                             # both above
            (z, v0, -up, m, r),                            # n.l < 0
            (z, -v0, up, m, r),                            # n.v < 0
            (z, v0, side, m, r),                           # n.l = 0
            (z, v0, -v0, m, r),                            # l = -v: h = 0
            (z, v0, -v0 + np.float32(1e-4) * z, m, r),     # l.h near 0
            (z, v0, -v0 + np.float32(3e-7) * up, m, r),
            (np.float32(2.5) * up, v0, up, m, r),          # |n| != 1
            (np.float32(0.3) * z, v0, up, m, r),
            (np.zeros(3, np.float32), v0, up, m, r),       # n = 0
            (z, np.float32(7.0) * v0, np.float32(0.01) * up, m, r),  # |v|, |l| != 1
            (z, z, z, m, r),                               # l = v = n
        ]
    cols.append((z, np.array([np.nan, 0.1, 0.9], np.float32), up, 0.5, 0.5))  # a NaN lane
    cols.append((z, v0, up, np.nan, 0.5))
    cols.append((z, v0, up, 0.5, np.nan))
    edge = [np.stack([c[i] for c in cols], axis=1) for i in range(3)]
    edge += [np.array([c[i] for c in cols], np.float32) for i in (3, 4)]
    n = len(cols) if n is None else n
    k = max(n - len(cols), 0)
    rand = [_unit(gen, k), _unit(gen, k), _unit(gen, k),
            gen.random(k, dtype=np.float32), gen.random(k, dtype=np.float32)]
    rand[1][:, : k // 2] *= gen.random(k // 2, dtype=np.float32) * 2  # some |v| != 1
    return [np.concatenate([e, r], axis=-1)[..., :n].astype(np.float32)
            for e, r in zip(edge, rand)]


def sample_inputs(n=None, seed=0):
    """(u3, in_dir, n, metallic, roughness) as float32 numpy arrays: the
    edge lanes (u at 0 and just below 1, axis normals, |n| != 1, rough 0,
    metallic 0 and 1) then random ones, cut to n lanes (None: the edge
    lanes alone)."""
    gen = np.random.default_rng(seed)
    cols = []
    d0 = np.array([0.3, -0.4, -0.85], np.float32)
    d0 /= np.linalg.norm(d0)
    normals = [np.array(x, np.float32) for x in ((0, 0, 1), (0, 0, -1), (1, 0, 0), (0, 1, 0),
                                                  (0.6, 0.0, 0.6), (2.0, 0.5, -3.0),
                                                  (0.01, 0.02, 0.03), (0, 0, 0))]
    us = (0.0, 0.25, BELOW_ONE)
    for nn in normals:
        for m, r in ((0.0, 0.0), (1.0, 0.3), (0.5, 1.0)):
            for a in us:
                for b in us:
                    for c in us:
                        cols.append((np.array([a, b, c], np.float32), d0, nn, m, r))
    cols.append((np.array([0.5, 0.5, 0.5], np.float32), np.float32(3.0) * d0, normals[0],
                 0.2, 0.2))
    cols.append((np.array([0.5, np.nan, 0.5], np.float32), d0, normals[0], 0.2, 0.2))
    edge = [np.stack([c[i] for c in cols], axis=1) for i in range(3)]
    edge += [np.array([c[i] for c in cols], np.float32) for i in (3, 4)]
    n = len(cols) if n is None else n
    k = max(n - len(cols), 0)
    rand = [gen.random((3, k), dtype=np.float32), _unit(gen, k), _unit(gen, k),
            gen.random(k, dtype=np.float32), gen.random(k, dtype=np.float32)]
    return [np.concatenate([e, r], axis=-1)[..., :n].astype(np.float32)
            for e, r in zip(edge, rand)]


def _tensors(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _bits_equal(a, b):
    """Bit for bit, any NaN equal to any NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return bool(same.all())


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("true_pdf", [False, True])
@pytest.mark.parametrize("n", [1, 31, 700])
def test_cpu_evaluate_takes_the_plain_twin(fresh, n, true_pdf):
    """CPU tensors go to the plain twin: no build, no launch, and the
    pre-change function's bits."""
    args = _tensors(eval_inputs(n, seed=n))
    got = planar.disney_evaluate_pdf(*args, true_pdf=true_pdf)
    want = frozen.disney_evaluate_pdf(*args, true_pdf=true_pdf)
    twin = planar.disney_evaluate_pdf_plain(*args, true_pdf=true_pdf)
    for g, w, t in zip(got, want, twin):
        assert g.device.type == "cpu" and _bits_equal(g, w) and _bits_equal(t, w)
    assert not planar.DISNEY_KERNEL.launches and planar.DISNEY_KERNEL._lib is None


@pytest.mark.parametrize("n", [1, 31, 700])
def test_cpu_sample_takes_the_plain_twin(fresh, n):
    args = _tensors(sample_inputs(n, seed=n))
    got = planar.disney_sample(*args)
    assert got.device.type == "cpu" and got.shape == (3, n)
    assert _bits_equal(got, frozen.disney_sample(*args))
    assert _bits_equal(planar.disney_sample_plain(*args), got)
    assert not planar.DISNEY_KERNEL.launches and planar.DISNEY_KERNEL._lib is None


def test_plain_twins_torch_calls():
    """The plain twins' top-level torch calls per call (what the kernel
    route saves), counted as tools/profile_bdpt.py counts a frame's, under
    the dispatcher's span."""
    e = _tensors(eval_inputs(64))
    s = _tensors(sample_inputs(64))
    calls = {
        "eval": count_ops(lambda: planar.disney_evaluate_pdf(*e)),
        "eval_true_pdf": count_ops(lambda: planar.disney_evaluate_pdf(*e, true_pdf=True)),
        "sample": count_ops(lambda: planar.disney_sample(*s)),
    }
    print(f"plain twins: {calls} top-level torch calls")
    assert calls == {"eval": {"bsdf.disney": 148}, "eval_true_pdf": {"bsdf.disney": 149},
                     "sample": {"bsdf.disney": 289}}


@pytest.mark.parametrize("op", ["eval", "sample"])
def test_dispatch_is_a_span(fresh, op):
    """Each dispatch records one `bsdf.disney` span (op, route, width)
    while recording is on, and none while it is off."""
    if op == "eval":
        args = _tensors(eval_inputs(40))
        run = lambda: planar.disney_evaluate_pdf(*args)  # noqa: E731
    else:
        args = _tensors(sample_inputs(40))
        run = lambda: planar.disney_sample(*args)  # noqa: E731
    run()
    assert not metrics.spans()
    with metrics.recording():
        run()
    (rec,) = metrics.spans()
    assert rec.name == "bsdf.disney" and rec.attrs == {"op": op, "route": "plain", "width": 40}


@pytest.mark.parametrize("op", ["eval", "sample"])
def test_wrapper_checks_raise(fresh, op):
    """A wrong dtype, shape or device mix, a non-tensor or a non-CUDA
    device raises ValueError before any build or launch."""
    k = planar.DISNEY_KERNEL
    call = k.evaluate_pdf if op == "eval" else k.sample
    good = _tensors(eval_inputs(16) if op == "eval" else sample_inputs(16))
    with pytest.raises(ValueError, match="CUDA"):
        call(*good)
    for i in range(5):
        bad = list(good)
        bad[i] = good[i].double()
        with pytest.raises(ValueError, match="float32"):
            call(*bad)
        bad[i] = good[i].to("meta")
        with pytest.raises(ValueError, match="lie on"):
            call(*bad)
        bad[i] = torch.cat([good[i], good[i][..., :1]], dim=-1)  # one lane more
        with pytest.raises(ValueError, match=r"must be \("):
            call(*bad)
        bad[i] = good[i].tolist()
        with pytest.raises(ValueError, match="tensor"):
            call(*bad)
    for i in range(3):
        bad = list(good)
        bad[i] = torch.cat([good[i], good[i][:1]])  # (4, N)
        with pytest.raises(ValueError, match=r"\(3, "):
            call(*bad)
        bad[i] = good[i][0]  # (N,)
        with pytest.raises(ValueError, match=r"\(3, "):
            call(*bad)
    for i in (3, 4):
        bad = list(good)
        bad[i] = good[i][None]  # (1, N)
        with pytest.raises(ValueError, match="lane values"):
            call(*bad)
    meta = [t.to("meta") for t in good]
    with pytest.raises(ValueError, match="CUDA"):
        call(*meta)
    assert not k.launches and k._lib is None


def test_build_hash_covers_the_header():
    """disney.cu's library is named by its text and disney.cuh's, so an
    edited header rebuilds it; a source without csrc/ includes (rng.cu)
    hashes as its own bytes, as before."""
    with open(os.path.join(cuda_build.CSRC, "disney.cu"), "rb") as f:
        cu = f.read()
    with open(os.path.join(cuda_build.CSRC, "disney.cuh"), "rb") as f:
        cuh = f.read()
    assert cuda_build._text_with_headers(os.path.join(cuda_build.CSRC, "disney.cu")) == cu + cuh
    with open(os.path.join(cuda_build.CSRC, "rng.cu"), "rb") as f:
        assert cuda_build._text_with_headers(os.path.join(cuda_build.CSRC, "rng.cu")) == f.read()


def _call_sites():
    """{(file, line)} of every call of a Disney entry in the four
    integrator modules, from their source."""
    sites = set()
    for name in SITE_FILES:
        with open(os.path.join(INTEGRATORS, name)) as f:
            for i, line in enumerate(f, 1):
                if CALL.search(line) and not line.lstrip().startswith("def "):
                    sites.add((name, i))
    return sites


@pytest.fixture(scope="module")
def cpu_scenes():
    veach, vcfg = scenes.example_cached("veach_bdpt", "cpu")
    box, bcfg = scenes.example_cached("spectral_box", "cpu")
    return {"veach": (veach, vcfg), "box": (box, bcfg)}


def test_every_call_site_goes_through_the_dispatcher(fresh, monkeypatch, cpu_scenes):
    """One small frame of each integrator (BDPT exact and corrected, PT
    with NEE, the spectral path tracer and the spectral BDPT) on the CPU,
    with the plain twins replaced by recorders: every call of a Disney
    entry in pt_rgb, bdpt_rgb, pt_spec and bdpt_spec reached the twins
    through the dispatcher, and each call's arguments pass the kernel
    wrapper's shape and dtype checks (only the device check fails)."""
    seen, args_seen = set(), []
    real_eval, real_sample = planar.disney_evaluate_pdf_plain, planar.disney_sample_plain

    def record(real, op):
        def inner(*args, **kwargs):
            f = sys._getframe(1)
            assert f.f_code.co_name in ("disney_evaluate_pdf", "disney_sample")
            while f is not None:
                if os.path.dirname(f.f_code.co_filename) == INTEGRATORS:
                    seen.add((os.path.basename(f.f_code.co_filename), f.f_lineno))
                f = f.f_back
            args_seen.append((op, args[:5]))
            return real(*args, **kwargs)
        return inner

    monkeypatch.setattr(planar, "disney_evaluate_pdf_plain", record(real_eval, "eval"))
    monkeypatch.setattr(planar, "disney_sample_plain", record(real_sample, "sample"))

    veach, vcfg = cpu_scenes["veach"]
    spec, cam = scenes.make_camera(veach, vcfg, 8, 8)
    key = rng.PRNGKey(3)
    for corrected in (False, True):
        bdpt_rgb.render_frame(veach, spec, cam, 0, key, corrected=corrected)
    pt_rgb.render_frame(veach, spec, cam, 0, key, nee=True)
    box, bcfg = cpu_scenes["box"]
    bspec, bcam = scenes.make_camera(box, bcfg, 8, 8)
    render_batch(box, bcfg, bspec, bcam, film.new_film(8, 8, seed=1, device="cpu"), 1,
                 "pt_spec", sdata=spectral_data(bcfg, "pt_spec", torch.device("cpu")))
    bdpt_spec.render_film_frames(box, bspec, bcam, film.new_film(8, 8, seed=1, device="cpu"),
                                 bdpt_spec.make_render_frame(device="cpu"), n_frames=1)

    missing = _call_sites() - seen
    assert not missing, f"call sites that did not reach the dispatcher: {sorted(missing)}"
    for op, args in args_seen:
        with pytest.raises(ValueError, match="CUDA device"):
            planar.DISNEY_KERNEL.check(op, args[:3], args[3:5])


def _program(cell, size, device):
    wl = registry.workload(cell)
    wl.update(width=size, height=size)
    config = registry.config(wl["config"])
    return program.setup(config, wl, torch.device(device)), wl, config


@pytest.mark.parametrize("cell", ["veach.bdpt", "veach.pt_nee"])
def test_cpu_frame_keeps_film_and_torch_calls(fresh, monkeypatch, cell):
    """A 16^2 frame of BDPT and of PT+NEE on the CPU: the film equals the
    frozen pre-change reference's replay of the same call, and the count
    of top-level torch calls equals the same call with the integrators
    wired to the plain twins directly, as before the dispatcher."""
    prog, wl, config = _program(cell, 16, "cpu")
    out = {}
    counted = count_ops(lambda: out.__setitem__("film", prog.call(prog.new_film(5), 1)[0]))
    ref = ref_render.build(config, wl, "cpu")
    want = ref_render.render_call(ref, ref_film.new_film(16, 16, seed=5, device="cpu"), 1)[0]
    assert torch.equal(out["film"].hdr, want.hdr) and float(want.hdr.abs().sum()) > 0

    for mod in (pt_rgb, bdpt_rgb):
        monkeypatch.setattr(mod, "disney_evaluate_pdf", planar.disney_evaluate_pdf_plain)
        monkeypatch.setattr(mod, "disney_sample", planar.disney_sample_plain)
    monkeypatch.setattr(bdpt_rgb, "_evaluate_pdf",
                        metrics.spanned("bdpt.pdf")(planar.disney_evaluate_pdf_plain))
    before = count_ops(lambda: out.__setitem__("before", prog.call(prog.new_film(5), 1)[0]))
    assert torch.equal(out["before"].hdr, out["film"].hdr)
    assert sum(counted.values()) == sum(before.values())
    assert counted.get("bsdf.disney", 0) > 0 and "bsdf.disney" not in before


def test_route_share_reader(fresh, monkeypatch):
    """benchmark/metrics/bsdf_kernel.route_share.py: the kernel-route
    `bsdf.disney` spans over all of them in the device-profiled calls;
    None where there are none (the parent) or nothing was traced."""
    from harness import profile

    R = metrics.SpanRecord
    s = 10 ** 9
    recs = []
    for call, t, routes in ((1, 10, ["plain"]), (10, 20, ["kernel", "kernel", "plain"]),
                            (20, 101, ["plain"])):
        base = t * s
        recs += [R(call + 1 + i, call, call, "bsdf.disney", base + 10 + i, base + 20 + i,
                   {"op": "eval", "route": r, "width": 8}) for i, r in enumerate(routes)]
        recs.append(R(call, None, call, "render.call", base, base + 3000, {}))
    host = profile.Trace(device=[], host=[(100.0, 100.5, "aten::mul")], window_s=1.0)
    dev = profile.Trace(device=[(1.0, 2.0, "k")], host=[], window_s=1.0)
    rec = SimpleNamespace(trace=dev, host_traces=[host], traced_calls=1, trace_frames=4)
    read = registry.reader("bsdf_kernel.route_share")
    monkeypatch.setattr(bench_spans, "recorded", lambda: recs)
    assert read(rec) == pytest.approx(2 / 3)  # call 10 alone: the last before the host slice
    monkeypatch.setattr(bench_spans, "recorded",
                        lambda: [r for r in recs if r.name != "bsdf.disney"])
    assert read(rec) is None
    monkeypatch.setattr(bench_spans, "recorded", lambda: None)
    assert read(rec) is None
    assert read(SimpleNamespace(trace=None, trace_frames=0)) is None


# ------------------------------------------------------------------ GPU


def _eval_both(args, true_pdf):
    """The kernel through the dispatcher and the plain twin, both on the
    card: (kernel, plain) outputs."""
    got = planar.disney_evaluate_pdf(*args, true_pdf=true_pdf)
    torch.cuda.synchronize()
    want = planar.disney_evaluate_pdf_plain(*args, true_pdf=true_pdf)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("true_pdf", [False, True])
@pytest.mark.parametrize("n", [1, 31, 131072, 262145])
def test_kernel_evaluate_bit_equal(cuda, fresh, n, true_pdf):
    args = _tensors(eval_inputs(n, seed=n), "cuda")
    (brdf, pdf), (want_brdf, want_pdf) = _eval_both(args, true_pdf)
    assert brdf.shape == pdf.shape == (n,) and brdf.is_contiguous() and pdf.is_contiguous()
    assert _bits_equal(brdf, want_brdf) and _bits_equal(pdf, want_pdf)
    assert planar.DISNEY_KERNEL.launches == {"eval": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 131072, 262145])
def test_kernel_sample_bit_equal(cuda, fresh, n):
    args = _tensors(sample_inputs(n, seed=n), "cuda")
    got = planar.disney_sample(*args)
    torch.cuda.synchronize()
    assert got.shape == (3, n) and got.is_contiguous()
    assert _bits_equal(got, planar.disney_sample_plain(*args))
    assert planar.DISNEY_KERNEL.launches == {"sample": 1}


@pytest.mark.gpu
def test_kernel_edge_lanes_bit_equal(cuda, fresh):
    """Every edge lane alone at the front of the batch, and the outputs'
    special values (the invalid lanes' (0, -1), NaN lanes) present."""
    e = _tensors(eval_inputs(), "cuda")
    for true_pdf in (False, True):
        (brdf, pdf), (wb, wp) = _eval_both(e, true_pdf)
        assert _bits_equal(brdf, wb) and _bits_equal(pdf, wp)
        assert bool((pdf == -1.0).any()) and bool(torch.isnan(brdf).any())
    s = _tensors(sample_inputs(), "cuda")
    assert _bits_equal(planar.disney_sample(*s), planar.disney_sample_plain(*s))


@pytest.mark.gpu
def test_zero_lanes_launch_nothing(cuda, fresh):
    e = _tensors(eval_inputs(0), "cuda")
    brdf, pdf = planar.disney_evaluate_pdf(*e)
    assert brdf.shape == pdf.shape == (0,) and brdf.device.type == "cuda"
    d = planar.disney_sample(*_tensors(sample_inputs(0), "cuda"))
    assert d.shape == (3, 0) and d.device.type == "cuda"
    assert not planar.DISNEY_KERNEL.launches


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 131072])
def test_kernel_takes_strided_and_expanded_inputs(cuda, fresh, n):
    """Row slices, transposed rows, lane stride 2 and stride-0 expanded
    inputs are read by their strides, with the plain twin's bits."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    rows = torch.randn(n, 3, device=dev, generator=g)               # (3, n) view, strides (1, 3)
    wide = torch.randn(3, 2 * n, device=dev, generator=g)[:, ::2]  # lane stride 2
    n1 = torch.randn(3, 1, device=dev, generator=g).expand(3, n)   # one normal for all
    u8 = torch.rand(8, n, device=dev, generator=g)
    m = torch.tensor(0.25, device=dev).expand(n)                   # stride 0
    r = torch.rand(2 * n, device=dev, generator=g)[1::2]
    ev = (n1, rows.T, wide, m, r)
    for true_pdf in (False, True):
        (brdf, pdf), (wb, wp) = _eval_both(ev, true_pdf)
        assert _bits_equal(brdf, wb) and _bits_equal(pdf, wp)
    sa = (u8[3:6], rows.T, n1, r, m)
    assert _bits_equal(planar.disney_sample(*sa), planar.disney_sample_plain(*sa))
    sa = (u8[::3], wide, rows.T, m, r)  # rows 0, 3, 6
    assert _bits_equal(planar.disney_sample(*sa), planar.disney_sample_plain(*sa))
    assert planar.DISNEY_KERNEL.launches == {"eval": 2, "sample": 2}


@pytest.mark.gpu
def test_kernel_route_torch_calls(cuda, fresh):
    """A kernel-route call costs at most 13 (evaluate) or 12 (sample)
    top-level torch calls: the allocation, the pointers and strides, the
    rows' unbind."""
    e = _tensors(eval_inputs(4096), "cuda")
    s = _tensors(sample_inputs(4096), "cuda")
    planar.disney_evaluate_pdf(*e)
    planar.disney_sample(*s)  # the build
    ev = sum(count_ops(lambda: planar.disney_evaluate_pdf(*e, true_pdf=True)).values())
    sa = sum(count_ops(lambda: planar.disney_sample(*s)).values())
    print(f"top-level torch calls per kernel-route call: eval {ev}, sample {sa}")
    assert ev <= 13 and sa <= 12
    assert planar.DISNEY_KERNEL.build_info is not None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_path_bit_equal_to_the_plain_route(cuda, fresh, monkeypatch, cell):
    """One call of each cell's path at a small size (merged PT, one-frame
    PT, PT+NEE exact, BDPT sliced) gives the film of the same call with
    the dispatcher forced to the plain route, bit for bit; the kernels
    launched in the first and only there.  The PT cells shade through
    csrc/pt_shade.cu, which makes no Disney dispatch: there the Disney
    kernels never launch and the shading kernel does."""
    prog, wl, _ = _program(cell, 16 if cell == "bench_100k.batch" else 32, "cuda")
    n = wl["frames_per_call"] if cell != "veach.pt_nee" else 2
    pt_rgb.SHADE_KERNEL.reset_counts()
    got = prog.call(prog.new_film(11), n)[0].hdr
    torch.cuda.synchronize()
    launches = dict(planar.DISNEY_KERNEL.launches)
    if wl["integrator"] == "pt_rgb":
        assert not launches and pt_rgb.SHADE_KERNEL.launches
    else:
        assert launches.get("eval", 0) > 0 and launches.get("sample", 0) > 0
    kernel = planar.DISNEY_KERNEL
    monkeypatch.setattr(planar, "DISNEY_KERNEL", SimpleNamespace(  # the plain route on the card
        evaluate_pdf=planar.disney_evaluate_pdf_plain, sample=planar.disney_sample_plain))
    want = prog.call(prog.new_film(11), n)[0].hdr
    assert torch.equal(got, want) and float(want.abs().sum()) > 0
    assert dict(kernel.launches) == launches
