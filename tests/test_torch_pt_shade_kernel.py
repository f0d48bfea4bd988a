"""The path tracer's shading kernel (ti_raytrace_tpu_torch/csrc/pt_shade.cu
over disney.cuh) and what surrounds it in integrators/pt_rgb.py: the router
`_shade`, the wrapper (`SHADE_KERNEL`), the plain twin `_shade_plain`, the
`pt.shade` span's route and width, and the benchmark's reader of them
(`shade_kernel.route_share`).

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_pt_shade_kernel.py -m gpu --noconftest -p no:cacheprovider

The CPU cases hold the plain route to the pre-change `_shade` (the
benchmark's frozen copy, `benchmark/reference/plain/integrators/pt_rgb.py`)
bit for bit, check the span's attributes, the wrapper's checks and the way
it hands the kernel its inputs' strides, the build hash, and that a PT and
a PT+NEE frame keep their film and their torch calls.  The `gpu` cases
launch the kernel and hold it against the plain twin on the card bit for
bit (NaN-aware on the int32 views: the kernel repeats the twin's float32
operations in ATen's order, so there is no tolerance): on synthetic lanes
of every kind at five widths, on strided and expanded inputs, on every
shading call of real PT and PT+NEE frames (head and tail around the real
shadow trace), on each PT cell's call against the same call with the plain
route forced, and the kernel's powf / expf against torch.pow / torch.exp
over every float32 of their domains.
"""

import ctypes
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.bsdf.planar import glass_sample
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.examples import scenes
from ti_raytrace_tpu_torch.integrators import pt_rgb
from ti_raytrace_tpu_torch.ops import cuda_build
from ti_raytrace_tpu_torch.ops.shading import decode_hit
from ti_raytrace_tpu_torch.scene.packs import PRIM_A
from ti_raytrace_tpu_torch.tools.profile_bdpt import count_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import program, registry  # noqa: E402
from harness import spans as bench_spans  # noqa: E402
from reference import render as ref_render  # noqa: E402
from reference.plain import film as ref_film  # noqa: E402
from reference.plain.integrators import pt_rgb as frozen  # noqa: E402  (the pre-change _shade)

torch.set_num_threads(2)

PT_CELLS = ["bench_100k.batch", "bench_100k.preview", "veach.pt_nee", "single_model.batch"]
CARRY = ("origin", "direction", "throughput", "radiance", "alive", "brdf_pdf", "perfect_spec",
         "miss_dir", "miss_weight", "pixel")
N_LIGHTS = 3
FAKE_SCENE = SimpleNamespace(n_lights=N_LIGHTS)  # all that _shade reads of a scene here


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def fresh():
    metrics.clear_spans()
    yield
    metrics.clear_spans()


def _unit(gen, n):
    v = gen.standard_normal((3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def shade_inputs(n, seed=0, device="cpu"):
    """Synthetic lanes of one shading call: (carry, u, t, prim, uv_bary,
    attr, ls, sh_prim), ls holding what sample_li's result is read for.
    Lanes of every kind: dead (~1/5), misses (t = INF, prim -1, zero
    attributes), emitters, glass entering and leaving (total internal
    reflection), Disney hits, sphere shapes, clear glass (extinction 0:
    every transmission is killed), a NaN lane; shadow rays that reach the
    lane's prim and ones that do not."""
    gen = np.random.default_rng(seed)
    f32 = np.float32
    o = gen.uniform(-3, 3, (3, n)).astype(f32)
    d = _unit(gen, n)
    t = gen.uniform(0.01, 8.0, n).astype(f32)
    prim = gen.integers(0, 1000, n).astype(np.int32)
    bary = gen.random((2, n), dtype=f32)
    bary[:, bary.sum(0) > 1] = 1 - bary[:, bary.sum(0) > 1]
    attr = np.zeros((PRIM_A, n), f32)
    g = _unit(gen, n)
    attr[0:3] = g
    for r in (3, 6, 9):  # vertex normals near the face normal
        attr[r:r + 3] = g + 0.3 * _unit(gen, n)
    mat = gen.choice([C.MAT_DISNEY, C.MAT_GLASS, C.MAT_LIGHT], n, p=[0.45, 0.4, 0.15])
    attr[18] = mat
    attr[19:22] = gen.uniform(0.0, 1.2, (3, n))
    attr[19:22, mat == C.MAT_LIGHT] *= 40.0
    attr[19:22, gen.random(n) < 0.05] = 0.02  # below the sRGB knee
    glass = mat == C.MAT_GLASS
    attr[22] = np.where(glass, gen.uniform(1.05, 2.4, n), gen.random(n))
    attr[23] = np.where(glass, gen.uniform(0.0, 6.0, n), gen.random(n))
    attr[23, gen.random(n) < 0.1] = 0.0
    attr[24] = gen.uniform(0.01, 5.0, n)
    attr[25] = gen.random(n) < 0.3
    attr[26:29] = o + d * t + gen.uniform(-1.0, 1.0, (3, n))  # sphere centres off the hit
    miss = gen.random(n) < 0.15
    t[miss] = np.where(gen.random(int(miss.sum())) < 0.5, f32(C.INF), f32(2e6))
    prim[miss] = -1
    attr[:, miss] = 0.0
    u = gen.random((8, n), dtype=f32)
    carry = dict(
        origin=o, direction=d,
        throughput=gen.uniform(0.0, 1.0, (3, n)).astype(f32),
        radiance=gen.uniform(0.0, 0.2, (3, n)).astype(f32),
        alive=gen.random(n) < 0.8,
        brdf_pdf=gen.uniform(0.0, 2.0, n).astype(f32),
        perfect_spec=gen.random(n) < 0.4,
        miss_dir=_unit(gen, n),
        miss_weight=gen.uniform(0.0, 1.0, (3, n)).astype(f32),
        pixel=np.arange(n, dtype=np.int64),
    )
    carry["radiance"][:, gen.random(n) < 0.1] = -0.0
    if n > 4:
        carry["direction"][:, 4] = np.nan
    ls = dict(pos=gen.uniform(-3, 3, (3, n)).astype(f32), normal=_unit(gen, n),
              direction=_unit(gen, n), emission=gen.uniform(0.0, 30.0, (3, n)).astype(f32),
              dist=gen.uniform(0.05, 10.0, n).astype(f32),
              choice_pdf=gen.uniform(0.01, 2.0, n).astype(f32))
    sh_prim = np.where(gen.random(n) < 0.7, prim, prim + 1).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ({k: dev(v) for k, v in carry.items()}, dev(u), dev(t), dev(prim), dev(bary),
            dev(attr), {k: dev(v) for k, v in ls.items()}, dev(sh_prim))


class _FakeNee:
    """sample_li and trace for `_shade` on a fake scene: they hand out the
    synthetic light sample and shadow prims, and record what they got."""

    def __init__(self, ls, sh_prim):
        self.ls, self.sh_prim, self.pos, self.sh_o = ls, sh_prim, [], []

    def sample_li(self, scene, pos, u3):
        assert scene is FAKE_SCENE and u3.shape[0] == 3
        self.pos.append(pos)
        return self.ls

    def trace(self, scene, o, d, sort_small=False):
        self.sh_o.append(o)
        return None, self.sh_prim

    def patch(self, monkeypatch, module):
        monkeypatch.setattr(module, "sample_li", self.sample_li)
        monkeypatch.setattr(module, "trace", self.trace)


def _bits_equal(a, b):
    """Bit for bit, any NaN equal to any NaN (bool and int exactly)."""
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return bool(same.all())


def _carry_equal(got, want):
    assert set(got) == set(want) == set(CARRY)
    bad = [k for k in CARRY if not _bits_equal(got[k], want[k])]
    assert not bad, f"carry entries that differ: {bad}"


def _both(monkeypatch, inputs, nee, corrected, plain=pt_rgb._shade_plain):
    """(_shade's carry, plain's carry, the two fakes, the launches during
    the `_shade` call, from its spans: {"shade": by entry, "disney": by
    op}) on the same inputs."""
    carry, u, t, prim, uv, attr, ls, sh_prim = inputs
    fakes, outs = [], []
    for fn in (pt_rgb._shade, plain):
        fake = _FakeNee(ls, sh_prim)
        fake.patch(monkeypatch, pt_rgb)
        fake.patch(monkeypatch, frozen)
        if fn is pt_rgb._shade:
            metrics.clear_spans()
            with metrics.recording():
                outs.append(fn(FAKE_SCENE, carry, u, t, prim, uv, attr, nee, corrected))
            launched = dict(shade=metrics.kernel_launches("pt.shade", "entry"),
                            disney=metrics.kernel_launches("bsdf.disney", "op"))
            metrics.clear_spans()
        else:
            outs.append(fn(FAKE_SCENE, carry, u, t, prim, uv, attr, nee, corrected))
        fakes.append(fake)
    return outs[0], outs[1], fakes, launched


def _kinds(inputs):
    """Lane counts of the kinds shade_inputs promises, by the plain ops."""
    carry, u, t, prim, uv, attr, _, _ = inputs
    hit = decode_hit(carry["origin"], carry["direction"], t, prim, uv, attr)
    valid = hit.valid & carry["alive"]
    glass = valid & (hit.mat_type == C.MAT_GLASS)
    _, f_or_b = glass_sample(u[3], carry["direction"], hit.normal, hit.mat_p0)
    cos_i = (carry["direction"] * hit.normal).sum(0)
    beer_r = torch.exp(-t / torch.clamp(hit.mat_p1, min=1e-12))
    return dict(
        dead=int((~carry["alive"]).sum()), miss=int((carry["alive"] & ~hit.valid).sum()),
        light=int((valid & (hit.mat_type == C.MAT_LIGHT)).sum()),
        disney=int((valid & (hit.mat_type == C.MAT_DISNEY)).sum()),
        glass_in=int((glass & (cos_i <= 0)).sum()), glass_out=int((glass & (cos_i > 0)).sum()),
        transmitted=int((glass & (f_or_b < 0)).sum()),
        beer_kill=int((glass & (f_or_b < 0) & (u[6] >= beer_r)).sum()),
        shape=int((valid & (attr[25] > 0.5)).sum()))


# ------------------------------------------------------------------ CPU


def test_synthetic_lanes_cover_every_kind():
    kinds = _kinds(shade_inputs(4096, seed=1))
    assert all(v > 20 for v in kinds.values()), kinds
    carry, u, t, prim, uv, attr, _, _ = shade_inputs(4096, seed=1)
    hit = decode_hit(carry["origin"], carry["direction"], t, prim, uv, attr)
    leaving = (carry["alive"] & hit.valid & (hit.mat_type == C.MAT_GLASS)
               & ((carry["direction"] * hit.normal).sum(0) > 0))
    eta = hit.mat_p0
    cos = (carry["direction"] * hit.normal).sum(0)
    tir = leaving & (1.0 - eta * eta * (1.0 - cos * cos) <= 0.0)
    assert int(tir.sum()) > 20


@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("n", [1, 31, 700])
def test_cpu_takes_the_plain_twin(fresh, monkeypatch, n, nee, corrected):
    """CPU tensors go to the plain twin: the pre-change function's bits,
    shadow rays included (that the CPU route loads no library is a case of
    tests/test_torch_launcher.py)."""
    inputs = shade_inputs(n, seed=n)
    got, want, fakes, _ = _both(monkeypatch, inputs, nee, corrected, plain=frozen._shade)
    _carry_equal(got, want)
    _carry_equal(pt_rgb._shade_plain(FAKE_SCENE, *inputs[:6], nee, corrected), want)
    if nee:
        assert _bits_equal(fakes[0].pos[0], fakes[1].pos[0])
        assert _bits_equal(fakes[0].sh_o[0], fakes[1].sh_o[0])
    assert got["origin"].device.type == "cpu"


@pytest.mark.parametrize("nee", [False, True])
def test_shade_span_carries_route_and_width(fresh, monkeypatch, nee):
    """Each `pt.shade` span of the plain route carries route "plain" and
    the call's lanes; none records while recording is off."""
    inputs = shade_inputs(40, seed=2)
    fake = _FakeNee(inputs[6], inputs[7])
    fake.patch(monkeypatch, pt_rgb)
    pt_rgb._shade(FAKE_SCENE, *inputs[:6], nee)
    assert not metrics.spans()
    with metrics.recording():
        pt_rgb._shade(FAKE_SCENE, *inputs[:6], nee)
    recs = [r for r in metrics.spans() if r.name == "pt.shade"]
    assert len(recs) == 2 and all(r.attrs == {"route": "plain", "width": 40} for r in recs)
    assert [r.name for r in metrics.spans()].count("pt.nee") == (2 if nee else 0)


def _slots(inputs, tail):
    carry, u, t, prim, uv, attr, ls, sh_prim = inputs
    ins = list(pt_rgb._ShadeKernel._carry_in(carry, u, t, prim, uv, attr))
    ins += ([ls["direction"], ls["normal"], ls["emission"], ls["dist"], ls["choice_pdf"],
             sh_prim] if tail else [None] * 6)
    return ins


def test_wrapper_checks_raise(fresh, monkeypatch):
    """A wrong dtype, shape or device mix, a non-tensor or a non-CUDA
    device raises ValueError before any build or launch."""
    k = pt_rgb.SHADE_KERNEL
    monkeypatch.setattr(k, "launch", lambda *a: pytest.fail("launched"))
    good = _slots(shade_inputs(16, seed=3), tail=True)
    with pytest.raises(ValueError, match="CUDA"):
        k.check("tail", good)
    for i, (name, rows, dtype) in enumerate(pt_rgb._SLOTS):
        bad = list(good)
        bad[i] = good[i].double()
        with pytest.raises(ValueError, match="must be torch"):
            k.check("tail", bad)
        bad[i] = good[i].to("meta")
        with pytest.raises(ValueError, match="lie on"):
            k.check("tail", bad)
        bad[i] = torch.cat([good[i], good[i][..., :1]], dim=-1)  # one lane more
        with pytest.raises(ValueError, match="must be \\("):
            k.check("tail", bad)
        bad[i] = good[i][None] if rows is None else good[i][:1]  # a row short, or (1, N)
        with pytest.raises(ValueError, match="must be \\("):
            k.check("tail", bad)
        bad[i] = good[i].tolist()
        with pytest.raises(ValueError, match="tensor"):
            k.check("tail", bad)
    with pytest.raises(ValueError, match="CUDA"):
        k.check("tail", [x.to("meta") for x in good])
    carry, u, t, prim, uv, attr, ls, sh_prim = shade_inputs(16, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        k.shade(carry, u, t, prim, uv, attr)
    with pytest.raises(ValueError, match="CUDA"):
        k.head(carry, t, prim, attr)


def test_wrapper_hands_the_kernel_its_strides(fresh, monkeypatch):
    """The words the wrapper passes: each slot's pointer, row stride and
    lane stride in elements ((N,) inputs: row stride 0; slots the entry
    does not read: zeros), the mode, the flags, the outputs; the carry
    comes back as rows of one (7, 3, N) float block and one (2, N) bool
    block, with `pixel` passed through.  A recording library on the CPU
    stands in for the kernel."""
    k = pt_rgb._ShadeKernel()
    seen = []

    class Lib:
        def pt_shade_launch(self, words, mode, corrected, n_lights, out, flags, n, stream):
            words = list((ctypes.c_longlong * (3 * len(pt_rgb._SLOTS))).from_address(words))
            seen.append((words, mode, corrected, n_lights, out, flags, n, stream))
            return 0

    monkeypatch.setattr(k, "_lib", Lib())
    monkeypatch.setattr(k, "check", lambda op, tensors: (tensors[2].device, tensors[2].shape[0]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 77, raising=False)
    n = 9
    carry, u, t, prim, uv, attr, ls, sh_prim = shade_inputs(n, seed=4)
    carry["origin"] = torch.tensor([1.0, 2.0, 3.0])[:, None].expand(3, n)  # stride 0
    carry["direction"] = carry["direction"].T.contiguous().T                # strides (1, 3)
    wide = torch.zeros(3, 2 * n)
    carry["throughput"] = wide[:, ::2]                                      # lane stride 2
    u = torch.rand(16, n)[::2]                                              # row stride 2n
    out = k.shade(carry, u, t, prim, uv, attr, corrected=True,
                  nee=(ls, sh_prim, N_LIGHTS))
    words, mode, corrected, n_lights, out_p, flags_p, count, stream = seen[-1]
    slot = {name: words[3 * i:3 * i + 3] for i, (name, _, _) in enumerate(pt_rgb._SLOTS)}
    assert slot["origin"] == [carry["origin"].data_ptr(), 1, 0]
    assert slot["direction"] == [carry["direction"].data_ptr(), 1, 3]
    assert slot["throughput"] == [carry["throughput"].data_ptr(), 2 * n, 2]
    assert slot["u"] == [u.data_ptr(), 2 * n, 1]
    assert slot["t"] == [t.data_ptr(), 0, 1] and slot["attr"] == [attr.data_ptr(), n, 1]
    assert slot["shadow prim"] == [sh_prim.data_ptr(), 0, 1]
    assert (mode, corrected, n_lights, count, stream) == (pt_rgb._TAIL, 1, N_LIGHTS, n, 77)
    assert out["origin"].data_ptr() == out_p and out["brdf_pdf"].shape == (n,)
    assert out["brdf_pdf"].data_ptr() == out_p + 18 * n * 4
    assert out["alive"].data_ptr() == flags_p and out["perfect_spec"].data_ptr() == flags_p + n
    assert out["pixel"] is carry["pixel"] and out["alive"].dtype == torch.bool
    assert all(out[key].is_contiguous() for key in CARRY)
    k.shade(carry, u, t, prim, uv, attr)
    words, mode = seen[-1][:2]
    assert mode == pt_rgb._FULL and words[3 * 14:] == [0] * 18 and seen[-1][3] == 0
    pos, is_disney = k.head(carry, t, prim, attr)
    words, mode = seen[-1][:2]
    read = [name for i, (name, _, _) in enumerate(pt_rgb._SLOTS) if words[3 * i]]
    assert mode == pt_rgb._HEAD and read == ["origin", "direction", "t", "prim", "attr", "alive"]
    assert pos.shape == (3, n) and is_disney.shape == (1, n) and is_disney.dtype == torch.bool
    assert [s[1] for s in seen] == [pt_rgb._TAIL, pt_rgb._FULL, pt_rgb._HEAD]
    empty = shade_inputs(0, seed=4)
    k.shade(*empty[:6])
    assert len(seen) == 3  # zero lanes launch nothing


def test_build_hash_covers_the_headers():
    """pt_shade.cu's library is named by its text and disney.cuh's, so an
    edited header rebuilds it."""
    src = os.path.join(cuda_build.CSRC, "pt_shade.cu")
    with open(src, "rb") as f:
        cu = f.read()
    with open(os.path.join(cuda_build.CSRC, "disney.cuh"), "rb") as f:
        cuh = f.read()
    assert b'#include "disney.cuh"' in cu
    assert cuda_build._text_with_headers(src) == cu + cuh


def _program(cell, size, device):
    wl = registry.workload(cell)
    wl.update(width=size, height=size)
    config = registry.config(wl["config"])
    return program.setup(config, wl, torch.device(device)), wl, config


@pytest.mark.parametrize("cell", ["single_model.batch", "veach.pt_nee"])
def test_cpu_frame_keeps_film_and_torch_calls(fresh, monkeypatch, cell):
    """A 16^2 frame of PT (merged, dense tracer) and of PT+NEE on the CPU:
    the film equals the frozen pre-change reference's replay of the same
    call, and the count of top-level torch calls equals the same call with
    the integrator wired to the plain twin directly, as before the router;
    nothing launches."""
    monkeypatch.setattr(pt_rgb.SHADE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    prog, wl, config = _program(cell, 16, "cpu")
    out = {}
    counted = count_ops(lambda: out.__setitem__("film", prog.call(prog.new_film(5), 1)[0]))
    ref = ref_render.build(config, wl, "cpu")
    want = ref_render.render_call(ref, ref_film.new_film(16, 16, seed=5, device="cpu"), 1)[0]
    assert torch.equal(out["film"].hdr, want.hdr) and float(want.hdr.abs().sum()) > 0

    monkeypatch.setattr(pt_rgb, "_shade", pt_rgb._shade_plain)
    before = count_ops(lambda: out.__setitem__("before", prog.call(prog.new_film(5), 1)[0]))
    assert torch.equal(out["before"].hdr, out["film"].hdr)
    assert counted == before and counted.get("pt.shade", 0) > 0


def test_route_share_reader(fresh, monkeypatch):
    """benchmark/metrics/shade_kernel.route_share.py: the kernel-route
    `pt.shade` spans over all of them in the device-profiled calls; None
    where none carries a route (the parent) or nothing was traced."""
    from harness import profile

    R = metrics.SpanRecord
    s = 10 ** 9
    recs = []
    for call, t, routes in ((1, 10, ["plain"]), (10, 20, ["kernel", "kernel", "kernel", "plain"]),
                            (20, 101, ["plain"])):
        base = t * s
        recs += [R(call + 1 + i, call, call, "pt.shade", base + 10 + i, base + 20 + i,
                   {"route": r, "width": 8}) for i, r in enumerate(routes)]
        recs.append(R(call, None, call, "render.call", base, base + 3000, {}))
    host = profile.Trace(device=[], host=[(100.0, 100.5, "aten::mul")], window_s=1.0)
    dev = profile.Trace(device=[(1.0, 2.0, "k")], host=[], window_s=1.0)
    rec = SimpleNamespace(trace=dev, host_traces=[host], traced_calls=1, trace_frames=4)
    read = registry.reader("shade_kernel.route_share")
    monkeypatch.setattr(bench_spans, "recorded", lambda: recs)
    assert read(rec) == pytest.approx(3 / 4)  # call 10 alone: the last before the host slice
    parent = [r._replace(attrs={}) if r.name == "pt.shade" else r for r in recs]
    monkeypatch.setattr(bench_spans, "recorded", lambda: parent)  # spans without a route
    assert read(rec) is None
    monkeypatch.setattr(bench_spans, "recorded",
                        lambda: [r for r in recs if r.name != "pt.shade"])
    assert read(rec) is None
    monkeypatch.setattr(bench_spans, "recorded", lambda: None)
    assert read(rec) is None
    assert read(SimpleNamespace(trace=None, trace_frames=0)) is None


# ------------------------------------------------------------------ GPU


@pytest.mark.gpu
@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("n", [1, 31, 1024, 262144, 1048577])
def test_kernel_bit_equal(cuda, fresh, monkeypatch, n, nee, corrected):
    """The kernel route against the plain twin on the card, on synthetic
    lanes of every kind; under NEE also the head's hit positions (sample_li's
    input) and the shadow rays' origins."""
    inputs = shade_inputs(n, seed=n + 7 * nee + 3 * corrected, device="cuda")
    got, want, fakes, launched = _both(monkeypatch, inputs, nee, corrected)
    torch.cuda.synchronize()
    _carry_equal(got, want)
    if nee:
        assert _bits_equal(fakes[0].pos[0], fakes[1].pos[0])
        assert _bits_equal(fakes[0].sh_o[0], fakes[1].sh_o[0])
    assert launched["shade"] == ({"head": 1, "tail": 1} if nee else {"full": 1})
    assert not launched["disney"]  # the kernel route makes no Disney dispatch
    if n >= 1024:
        assert all(v > 0 for v in _kinds(inputs).values())


@pytest.mark.gpu
def test_kernel_nee_term_is_exercised(cuda, fresh, monkeypatch):
    """The synthetic lanes gain light through NEE: occluding every shadow
    ray changes the radiance of some lanes, in both routes alike."""
    inputs = list(shade_inputs(4096, seed=11, device="cuda"))
    got, want, _, _ = _both(monkeypatch, inputs, True, False)
    inputs[7] = torch.full_like(inputs[7], -2)
    got_occ, want_occ, _, _ = _both(monkeypatch, inputs, True, False)
    _carry_equal(got, want)
    _carry_equal(got_occ, want_occ)
    assert int((got["radiance"] != got_occ["radiance"]).any(0).sum()) > 50


@pytest.mark.gpu
def test_zero_lanes_launch_nothing(cuda, fresh, monkeypatch):
    monkeypatch.setattr(pt_rgb.SHADE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    for nee in (False, True):
        got, want, _, _ = _both(monkeypatch, shade_inputs(0, device="cuda"), nee, False)
        assert all(got[k].shape == want[k].shape for k in CARRY)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [31, 262144])
def test_kernel_takes_strided_and_expanded_inputs(cuda, fresh, monkeypatch, n):
    """A stride-0 expanded origin (the camera bounce's), transposed rows,
    lane stride 2, row slices of wider blocks: read by their strides, with
    the plain twin's bits."""
    carry, u, t, prim, uv, attr, ls, sh_prim = shade_inputs(n, seed=5, device="cuda")
    carry = dict(carry)
    carry["origin"] = torch.tensor([0.5, -1.0, 2.0], device="cuda")[:, None].expand(3, n)
    carry["direction"] = carry["direction"].T.contiguous().T
    for key in ("throughput", "miss_weight"):
        wide = torch.zeros(3, 2 * n, device="cuda")
        wide[:, ::2] = carry[key]
        carry[key] = wide[:, ::2]
    big = torch.zeros(16, n, device="cuda")
    big[::2] = u
    u = big[::2]
    alive = torch.zeros(2 * n, dtype=torch.bool, device="cuda")
    alive[1::2] = carry["alive"]
    carry["alive"] = alive[1::2]
    attr = torch.cat([attr, attr]).T.contiguous().T[:PRIM_A]  # lane-major (PRIM_A, N)
    ls = dict(ls, direction=ls["direction"].T.contiguous().T)
    for nee in (False, True):
        got, want, _, _ = _both(monkeypatch, (carry, u, t, prim, uv, attr, ls, sh_prim), nee,
                                True)
        _carry_equal(got, want)


def _compare_every_call(monkeypatch, calls):
    """Wrap pt_rgb._shade so that every call also runs the plain twin on
    the same inputs and the two carries must be equal bit for bit (the
    render continues with the kernel's)."""
    kernel_shade = pt_rgb._shade

    def both(scene, carry, u, t, prim, uv_bary, attr, nee=False, corrected=False):
        got = kernel_shade(scene, carry, u, t, prim, uv_bary, attr, nee, corrected)
        want = pt_rgb._shade_plain(scene, carry, u, t, prim, uv_bary, attr, nee, corrected)
        _carry_equal(got, want)
        calls.append(t.shape[0])
        return got

    monkeypatch.setattr(pt_rgb, "_shade", both)


@pytest.mark.gpu
@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("name", ["veach_bdpt", "benchmark_100k"])
def test_every_shading_call_of_a_frame(cuda, fresh, monkeypatch, name, corrected):
    """Every shading call of a 64^2 PT frame on the card, Veach with NEE
    (head and tail around the real sample_li and shadow trace) and the
    glass teapot without, equals the plain twin's on the same hit record."""
    scene, cfg = scenes.example_cached(name, "cuda")
    spec, cam = scenes.make_camera(scene, cfg, 64, 64)
    nee = pt_rgb.has_nee_materials(scene)
    assert nee == (name == "veach_bdpt")
    calls = []
    _compare_every_call(monkeypatch, calls)
    with metrics.recording():
        pt_rgb.render_frame(scene, spec, cam, 3, rng.PRNGKey(9), nee=nee, corrected=corrected)
    torch.cuda.synchronize()
    assert len(calls) > 3
    launches = metrics.kernel_launches("pt.shade", "entry")
    assert launches == ({"head": len(calls), "tail": len(calls)} if nee
                        else {"full": len(calls)})


@pytest.mark.gpu
@pytest.mark.parametrize("cell", PT_CELLS)
def test_cell_path_bit_equal_to_the_plain_route(cuda, fresh, monkeypatch, cell):
    """One call of each PT cell's path at a small size (merged PT, one-frame
    PT, PT+NEE exact, merged PT on the dense tracer) gives the film of the
    same call with `_shade` forced to the plain twin, bit for bit; the kernel
    launched in the first only, and no Disney kernel."""
    prog, wl, _ = _program(cell, 16 if cell.endswith(".batch") else 32, "cuda")
    n = wl["frames_per_call"] if cell != "veach.pt_nee" else 2
    with metrics.recording():
        got = prog.call(prog.new_film(11), n)[0].hdr
    torch.cuda.synchronize()
    launches = metrics.kernel_launches("pt.shade", "entry")
    assert launches.get("tail" if cell == "veach.pt_nee" else "full", 0) > 0
    assert not metrics.kernel_launches("bsdf.disney", "op")
    monkeypatch.setattr(pt_rgb.SHADE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(pt_rgb, "_shade", pt_rgb._shade_plain)
    want = prog.call(prog.new_film(11), n)[0].hdr
    assert torch.equal(got, want) and float(want.abs().sum()) > 0


@pytest.mark.gpu
def test_kernel_route_torch_calls(cuda, fresh, monkeypatch):
    """A kernel-route `_shade` costs at most 35 top-level torch calls
    without NEE and 63 under NEE (head and tail; sample_li and the shadow
    ray's origin are pt.nee's): the allocations, the pointers and strides,
    the carry's row views."""
    inputs = shade_inputs(4096, seed=6, device="cuda")
    fake = _FakeNee(inputs[6], inputs[7])
    fake.patch(monkeypatch, pt_rgb)
    pt_rgb._shade(FAKE_SCENE, *inputs[:6])  # the build
    full = count_ops(lambda: pt_rgb._shade(FAKE_SCENE, *inputs[:6]))
    nee = count_ops(lambda: pt_rgb._shade(FAKE_SCENE, *inputs[:6], True))
    print(f"top-level torch calls per kernel-route _shade: {full}, under NEE {nee}")
    assert full == {"pt.shade": full["pt.shade"]} and full["pt.shade"] <= 35
    assert nee["pt.shade"] <= 63
    assert pt_rgb.SHADE_KERNEL.build_info is not None


def _float_range(lo, hi):
    """Every float32 from lo to hi (both included, same sign), as the
    int32 bit patterns, in chunks."""
    a = int(np.array(lo, np.float32).view(np.int32))
    b = int(np.array(hi, np.float32).view(np.int32))
    a, b = min(a, b), max(a, b)
    step = 1 << 26
    for start in range(a, b + 1, step):
        yield torch.arange(start, min(start + step, b + 1), dtype=torch.int32,
                           device="cuda").view(torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["pow_2.4", "pow_5", "exp"])
def test_exhaustive_pow_and_exp(cuda, fn):
    """The kernel's powf(x, (float)2.4) (srgb_to_lrgb) over every float32 in
    [0.04045, 2], its powf(x, 5) (schlick) over every float32 in [0, 2] and
    its expf (Beer-Lambert) over every negative float32 (-0 and -inf
    included) equal torch.pow / torch.exp on the card bit for bit."""
    k = pt_rgb.SHADE_KERNEL
    exponent, lo, hi, ref = {
        "pow_2.4": (2.4, 0.04045, 2.0, lambda x: torch.pow(x, 2.4)),
        "pow_5": (5.0, 0.0, 2.0, lambda x: torch.pow(x, 5.0)),
        "exp": (None, -0.0, -np.inf, torch.exp),
    }[fn]
    total = 0
    for x in _float_range(lo, hi):
        got, want = k.math(x, exponent), ref(x)
        if not _bits_equal(got, want):
            bad = ~((got.view(torch.int32) == want.view(torch.int32))
                    | (got.isnan() & want.isnan()))
            i = int(bad.nonzero()[0])
            pytest.fail(f"{fn}: {int(bad.sum())} values differ in this chunk, e.g. x = "
                        f"{x[i].item()!r}: kernel {got[i].item()!r}, torch {want[i].item()!r}")
        total += x.numel()
    print(f"{fn}: {total} float32 values, all equal")
    assert total > 10 ** 7
