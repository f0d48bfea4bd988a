"""The cluster tracer's coherence sort key as a hand kernel
(ti_raytrace_tpu_torch/csrc/coherence_key.cu) and what surrounds it in
ops/cluster_trace.py: the router `sort_key` (and `coherence_key60`,
`_coherence_order`), the wrapper (`COHERENCE_KERNEL`), the plain twin
(`coherence_key60_plain`, `_sort_key_plain`), the `trace.order` span's
route and lane count, and the benchmark's reader of them
(`order_kernel.route_share`).

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_coherence_key_kernel.py -m gpu --noconftest -p no:cacheprovider

The CPU cases hold the plain route to the pre-change key and order (the
benchmark's frozen copy, `benchmark/reference/plain/ops/cluster_trace.py`)
bit for bit, check the span's attributes, the wrapper's checks and the
words it hands the kernel, and that a 16^2 PT+NEE frame keeps its film.
The `gpu` cases launch the kernel and hold its key and the stable order of
that key to the plain twin's on the card, bit for bit, at five widths, on
lanes of every kind: inside and outside the scene box, on the
quantisation's cell boundaries (where a product with a reciprocal and a
true division part), parked at 1e9, zero and negative-zero directions,
NaN and +-inf coordinates, with `active` (padding and PAD_KEY) and `alive`
(the dead bit) masks; then each cluster-tracer cell's call against the same
call with the plain route forced.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.ops import cluster_trace as ct
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
from reference.plain.ops import cluster_trace as frozen  # noqa: E402  (the pre-change key)

torch.set_num_threads(2)

CLUSTER_CELLS = ["bench_100k.batch", "veach.bdpt", "bench_100k.preview", "veach.pt_nee"]
WIDTHS = [1, 255, 256, 32769, 1048577]
KINDS = ("inside", "cell edge", "around", "parked", "direction edge", "zero direction",
         "nan/inf", "extreme")


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


def _nudge(x, ulps):
    """x moved by `ulps` steps of its float32 bit pattern (across zero the
    pattern gives negative NaNs and tiny values: inputs all the same)."""
    return (x.view(torch.int32) + ulps.to(torch.int32)).view(torch.float32)


def key_lanes(n, seed, device="cpu", flat=False):
    """(scene box, o, d, active, alive) for n lanes, each of a kind of KINDS
    drawn at random: origins uniform in the box, on a cell boundary of the
    1024^3 quantisation nudged by up to 3 ulps, in a box three times as
    wide, parked at 1e9; directions unit, on a direction cell boundary
    nudged, zero or negative zero; NaN, +-inf, +-3e38 and subnormal
    coordinates.  flat: the box has no depth on z (its span clamps to
    1e-12).  Drawn on the CPU, then moved to `device`."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([-1.3, -0.7, -2.1])
    hi = torch.tensor([1.9, 2.3, 0.45])
    if flat:
        hi[2] = lo[2]
    span = torch.clamp(hi - lo, min=1e-12)
    kind = torch.randint(0, len(KINDS), (n,), generator=g)

    def pick(k, x, y):
        return torch.where(kind == KINDS.index(k), y, x)

    u = torch.rand(3, n, generator=g)
    o = lo[:, None] + u * (hi - lo)[:, None]
    cell = torch.randint(0, 1025, (3, n), generator=g).double() / 1024
    edge = (lo.double()[:, None] + cell * span.double()[:, None]).float()
    o = pick("cell edge", o, _nudge(edge, torch.randint(-3, 4, (3, n), generator=g)))
    o = pick("around", o, lo[:, None] + (u * 3 - 1) * (hi - lo)[:, None])
    o = pick("parked", o, torch.full_like(o, 1e9))
    d = torch.nn.functional.normalize(torch.randn(3, n, generator=g), dim=0)
    dcell = (torch.randint(0, 1025, (3, n), generator=g).double() / 512 - 1).float()
    d = pick("direction edge", d, _nudge(dcell, torch.randint(-3, 4, (3, n), generator=g)))
    signs = torch.where(torch.rand(3, n, generator=g) < 0.5, 0.0, -0.0)
    d = pick("zero direction", d, signs)
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.5])
    o = pick("nan/inf", o, special[torch.randint(0, 4, (3, n), generator=g)])
    d = pick("nan/inf", d, special[torch.randint(0, 4, (3, n), generator=g)])
    extreme = torch.tensor([3e38, -3e38, 1e-40, -1e-40, 0.0])
    o = pick("extreme", o, extreme[torch.randint(0, 5, (3, n), generator=g)])
    d = pick("extreme", d, extreme[torch.randint(0, 5, (3, n), generator=g)])
    active = torch.rand(n, generator=g) > 0.25
    alive = torch.rand(n, generator=g) > 0.3
    box = SimpleNamespace(aabb_min=lo.to(device), aabb_max=hi.to(device))
    return box, o.to(device), d.to(device), active.to(device), alive.to(device)


def _n_pad(n):
    return -(-n // ct.TILE) * ct.TILE


def _program(cell, size, device):
    wl = registry.workload(cell)
    wl.update(width=size, height=size)
    config = registry.config(wl["config"])
    return program.setup(config, wl, torch.device(device)), wl, config


# ------------------------------------------------------------------ CPU


def test_lanes_cover_every_kind():
    """key_lanes draws every kind at a few hundred lanes, and its NaN, inf
    and parked origins reach the plain key."""
    box, o, d, _, _ = key_lanes(400, seed=1)
    assert bool(torch.isnan(o).any()) and bool(torch.isinf(d).any())
    assert bool((o == 1e9).all(dim=0).any())
    zero = (d == 0).all(dim=0)
    assert bool(zero.any()) and bool(torch.signbit(d[:, zero]).any())
    key = ct.coherence_key60_plain(box, o, d)
    assert key.dtype == torch.int64 and int(key.min()) >= 0 and int(key.max()) < 1 << 60


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("n", [1, 255, 256, 3001])
def test_cpu_takes_the_plain_twin(fresh, monkeypatch, n, flat):
    """On CPU tensors the router takes the plain twin and launches nothing:
    coherence_key60 and _coherence_order (with and without `active`) equal
    the frozen pre-change code's bit for bit, and the `alive` key is its
    pre-change composition (dead << 60) | key."""
    monkeypatch.setattr(ct.COHERENCE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    box, o, d, active, alive = key_lanes(n, seed=n + flat, flat=flat)
    key = ct.coherence_key60(box, o, d)
    assert torch.equal(key, frozen.coherence_key60(box, o, d))
    n_pad = _n_pad(n)
    for mask in (None, active):
        assert torch.equal(ct._coherence_order(box, o, d, n_pad, mask),
                           frozen._coherence_order(box, o, d, n_pad, mask))
    dead = (~alive).to(torch.int64)
    assert torch.equal(ct.sort_key(box, o, d, alive=alive), (dead << 60) | key)
    padded = ct.sort_key(box, o, d, n_pad, active)
    assert padded.shape == (n_pad,) and bool((padded[n:] == ct.PAD_KEY).all())
    assert bool((padded[:n][~active] == ct.PAD_KEY).all())


def test_route_by_device():
    """key_route: "kernel" on CUDA, "plain" on the CPU; any other device
    raises, and so does the router, with no fallback."""
    box, o, d, _, _ = key_lanes(8, seed=2)
    assert ct.key_route(o) == "plain"
    with pytest.raises(NotImplementedError, match="meta"):
        ct.key_route(o.to("meta"))
    with pytest.raises(NotImplementedError, match="meta"):
        ct.sort_key(box, o.to("meta"), d.to("meta"))
    with pytest.raises(NotImplementedError, match="meta"):
        ct.coherence_key60(box, o.to("meta"), d.to("meta"))


def test_wrapper_checks_raise(monkeypatch):
    """A wrong dtype, shape or device mix, a non-tensor, an n_pad below N
    or a non-CUDA device raises ValueError before any build or launch."""
    k = ct.COHERENCE_KERNEL
    monkeypatch.setattr(k, "launch", lambda *a: pytest.fail("launched"))
    box, o, d, active, alive = key_lanes(16, seed=3)
    good = [o, d, box.aabb_min, box.aabb_max, active, alive]

    def check(args, n_pad=16):
        return k.check(*args[:4], n_pad, *args[4:])

    for i, name in enumerate(("o", "d", "aabb_min", "aabb_max", "active", "alive")):
        bad = list(good)
        bad[i] = good[i].double()
        with pytest.raises(ValueError, match=f"{name} must be torch"):
            check(bad)
        bad[i] = good[i].to("meta")  # o sets the device: then d is the one elsewhere
        with pytest.raises(ValueError, match=f"{name if i else 'd'} must lie on"):
            check(bad)
        bad[i] = good[i][:2]  # a row or a lane short
        with pytest.raises(ValueError, match=f"{name} must be \\("):
            check(bad)
        bad[i] = good[i].tolist()
        with pytest.raises(ValueError, match=f"{name} must be a tensor"):
            check(bad)
    with pytest.raises(ValueError, match="n_pad 15 is below the 16 lanes"):
        check(good, n_pad=15)
    for args in (good, good[:4] + [None, None], [x.to("meta") for x in good]):
        with pytest.raises(ValueError, match="CUDA"):
            check(args)
    with pytest.raises(ValueError, match="CUDA"):
        k(o, d, box.aabb_min, box.aabb_max)


def test_wrapper_hands_the_kernel_its_words(fresh, monkeypatch):
    """The words the wrapper passes: o's and d's pointers with their row
    and lane strides in elements, the box's pointers and strides, each
    mask's pointer and lane stride (none: zeros), the key's pointer, N and
    n_pad; the key comes back as a new contiguous (n_pad,) int64 tensor;
    zero lanes launch nothing.  A recording library on the CPU stands in
    for the kernel."""
    k = ct._CoherenceKeyKernel()
    seen = []

    class Lib:
        def coherence_key_launch(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(k, "_lib", Lib())
    monkeypatch.setattr(k, "check", lambda o, d, lo, hi, n_pad, active, alive:
                        (o.device, o.shape[-1]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 77, raising=False)
    n = 9
    box, o, d, active, alive = key_lanes(n, seed=4)
    o = torch.tensor([1.0, 2.0, 3.0])[:, None].expand(3, n)     # strides (1, 0)
    d = d.T.contiguous().T                                       # strides (1, 3)
    wide = torch.zeros(2 * n, dtype=torch.bool)
    alive = wide[::2]                                            # lane stride 2
    lo = torch.zeros(6)[::2]                                     # stride 2
    with metrics.recording(), metrics.span("trace.order", route="kernel", n=n):
        key = k(o, d, lo, box.aabb_max, 256, active, alive)
    assert seen[-1] == (o.data_ptr(), 1, 0, d.data_ptr(), 1, 3, lo.data_ptr(), 2,
                        box.aabb_max.data_ptr(), 1, active.data_ptr(), 1, alive.data_ptr(), 2,
                        key.data_ptr(), n, 256, 77)
    assert key.shape == (256,) and key.dtype == torch.int64 and key.is_contiguous()
    assert metrics.kernel_launches("trace.order", "route") == {"kernel": 1}
    key = k(o, d, lo, box.aabb_max)
    assert seen[-1][10:17] == (0, 0, 0, 0, key.data_ptr(), n, n) and key.shape == (n,)
    empty = torch.zeros(3, 0)
    assert k(empty, empty, lo, box.aabb_max).shape == (0,)
    assert len(seen) == 2  # zero lanes launch nothing


def test_build_names_its_source():
    """The binding builds csrc/coherence_key.cu, which includes no csrc/
    header: its library is named by its own text."""
    src = os.path.join(cuda_build.CSRC, ct.COHERENCE_KERNEL.SOURCE)
    with open(src, "rb") as f:
        text = f.read()
    assert cuda_build._text_with_headers(src) == text
    assert b"coherence_key_launch" in text and b"coherence_key_error_string" in text
    assert set(ct.COHERENCE_KERNEL.ENTRIES) == {"coherence_key_launch"}


def test_order_spans_carry_route_and_n(fresh, monkeypatch):
    """A 16^2 PT+NEE call of veach.pt_nee on the CPU (the exact path: every
    bounce and shadow batch a sorted trace): every `trace.order` span
    carries route "plain" and n, its lanes, the width of the trace it
    orders; the film equals the frozen pre-change reference's replay of the
    same call; nothing launches."""
    monkeypatch.setattr(ct.COHERENCE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    prog, wl, config = _program("veach.pt_nee", 16, "cpu")
    with metrics.recording():
        got = prog.call(prog.new_film(5), 1)[0]
    orders = [r for r in metrics.spans() if r.name == "trace.order"]
    assert orders and all(r.attrs["route"] == "plain" for r in orders)
    assert all(isinstance(r.attrs["n"], int) and r.attrs["n"] > 0 for r in orders)
    kernels = [r for r in metrics.spans() if r.name == "trace.kernel"]
    assert {r.attrs["n_valid"] for r in kernels} >= {r.attrs["n"] for r in orders
                                                     if not r.attrs.get("carry")}
    ref = ref_render.build(config, wl, "cpu")
    want = ref_render.render_call(ref, ref_film.new_film(16, 16, seed=5, device="cpu"), 1)[0]
    assert torch.equal(got.hdr, want.hdr) and float(want.hdr.abs().sum()) > 0


def test_sort_carry_takes_the_router(fresh, monkeypatch):
    """pt_rgb._sort_carry (the presorted deep phases) on the CPU permutes
    the carry as the frozen pre-change code does, under one `trace.order`
    span with carry=True, route "plain" and n; nothing launches."""
    from reference.plain.integrators import pt_rgb as frozen_pt

    from ti_raytrace_tpu_torch.integrators import pt_rgb

    monkeypatch.setattr(ct.COHERENCE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    n = 777
    box, o, d, _, alive = key_lanes(n, seed=11)
    carry = dict(origin=o, direction=d, alive=alive, pixel=torch.arange(n))
    with metrics.recording():
        got = pt_rgb._sort_carry(box, carry)
    want = frozen_pt._sort_carry(box, carry)
    assert all(torch.equal(got[k], want[k]) for k in ("alive", "pixel"))
    assert all(torch.equal(got[k].view(torch.int32), want[k].view(torch.int32))
               for k in ("origin", "direction"))  # NaN lanes included
    assert not torch.equal(got["pixel"], carry["pixel"])
    (span,) = metrics.spans()
    assert (span.name, span.attrs) == ("trace.order", {"carry": True, "route": "plain", "n": n})


def test_route_share_reader(fresh, monkeypatch):
    """benchmark/metrics/order_kernel.route_share.py: the kernel-route
    `trace.order` spans over all of them that carry a route in the
    device-profiled calls; 1.0 on kernel spans alone, None where none
    carries a route (the parent) or nothing was traced."""
    from harness import profile

    R = metrics.SpanRecord
    s = 10 ** 9
    recs = []
    for call, t, routes in ((1, 10, ["plain"]), (10, 20, ["kernel", "kernel", "kernel", "plain"]),
                            (20, 101, ["plain"])):
        base = t * s
        recs += [R(call + 1 + i, call, call, "trace.order", base + 10 + i, base + 20 + i,
                   {"route": r, "n": 8}) for i, r in enumerate(routes)]
        recs.append(R(call, None, call, "render.call", base, base + 3000, {}))
    host = profile.Trace(device=[], host=[(100.0, 100.5, "aten::mul")], window_s=1.0)
    dev = profile.Trace(device=[(1.0, 2.0, "k")], host=[], window_s=1.0)
    rec = SimpleNamespace(trace=dev, host_traces=[host], traced_calls=1, trace_frames=4)
    read = registry.reader("order_kernel.route_share")
    monkeypatch.setattr(bench_spans, "recorded", lambda: recs)
    assert read(rec) == pytest.approx(3 / 4)  # call 10 alone: the last before the host slice
    kernel = [r._replace(attrs={"route": "kernel", "n": 8}) if r.name == "trace.order" else r
              for r in recs]
    monkeypatch.setattr(bench_spans, "recorded", lambda: kernel)
    assert read(rec) == 1.0
    parent = [r._replace(attrs={}) if r.name == "trace.order" else r for r in recs]
    monkeypatch.setattr(bench_spans, "recorded", lambda: parent)  # spans without a route
    assert read(rec) is None
    monkeypatch.setattr(bench_spans, "recorded",
                        lambda: [r for r in recs if r.name != "trace.order"])
    assert read(rec) is None
    monkeypatch.setattr(bench_spans, "recorded", lambda: None)
    assert read(rec) is None
    assert read(SimpleNamespace(trace=None, trace_frames=0)) is None


# ------------------------------------------------------------------ GPU


@pytest.mark.gpu
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("n", WIDTHS)
def test_kernel_bit_equal(cuda, fresh, n, flat):
    """The kernel's key, and the stable order of it, against the plain twin
    on the card: the bare key, the padded order with and without `active`,
    the `alive` key, and both masks at once; one launch each."""
    box, o, d, active, alive = key_lanes(n, seed=n + 5 * flat, device="cuda", flat=flat)
    n_pad = _n_pad(n)
    cases = [(None, None, None), (n_pad, None, None), (n_pad, active, None),
             (None, None, alive), (n_pad, active, alive)]
    with metrics.recording(), metrics.span("trace.order", route="kernel", n=n):
        for pad, act, alv in cases:
            got = ct.sort_key(box, o, d, pad, act, alv)
            want = ct._sort_key_plain(box, o, d, pad, act, alv)
            assert got.dtype == torch.int64 and torch.equal(got, want), (pad, act, alv)
            assert torch.equal(torch.sort(got, stable=True).indices,
                               torch.sort(want, stable=True).indices)
        want = ct._sort_key_plain(box, o, d, n_pad, active)
        assert torch.equal(ct._coherence_order(box, o, d, n_pad, active),
                           torch.sort(want, stable=True).indices)
        assert torch.equal(ct.coherence_key60(box, o, d), ct.coherence_key60_plain(box, o, d))
    torch.cuda.synchronize()
    assert metrics.kernel_launches("trace.order", "route") == {"kernel": len(cases) + 2}


@pytest.mark.gpu
def test_cell_edges_tell_division_from_reciprocal(cuda):
    """The boundary lanes of key_lanes are where `(o - lo) / span` taken
    as a true division and as a product with span's reciprocal part: the
    plain twin on the card takes one rule, the kernel the same one."""
    box, o, d, _, _ = key_lanes(1 << 20, seed=7, device="cuda")
    lo, span = box.aabb_min, torch.clamp(box.aabb_max - box.aabb_min, min=1e-12)
    q_div = [((o[k] - lo[k]) / span[k] * 1024.0).clamp(0, 1023).to(torch.int64)
             for k in range(3)]
    q_rcp = [((o[k] - lo[k]) * (1.0 / span[k]) * 1024.0).clamp(0, 1023).to(torch.int64)
             for k in range(3)]
    parted = sum(int((a != b).sum()) for a, b in zip(q_div, q_rcp))
    print(f"cell-edge lanes where division and reciprocal part: {parted}")
    assert parted > 0
    assert torch.equal(ct.coherence_key60(box, o, d), ct.coherence_key60_plain(box, o, d))


@pytest.mark.gpu
def test_kernel_reads_strided_inputs(cuda, fresh):
    """An expanded (stride-0) origin, a transposed direction, strided masks
    and a strided box: the key equals the plain twin's on contiguous
    copies."""
    n = 4099
    box, o, d, active, alive = key_lanes(n, seed=8, device="cuda")
    o_s = o[:, :1].expand(3, n)
    d_s = d.T.contiguous().T
    act_s = torch.stack([active, ~active], dim=1)[:, 0]
    alv_s = torch.stack([alive, ~alive], dim=1)[:, 0]
    lo_s = torch.stack([box.aabb_min, box.aabb_max], dim=1)[:, 0]
    assert o_s.stride() == (n, 0) and d_s.stride() == (1, 3)
    assert act_s.stride() == alv_s.stride() == lo_s.stride() == (2,)
    box_s = SimpleNamespace(aabb_min=lo_s, aabb_max=box.aabb_max)
    got = ct.sort_key(box_s, o_s, d_s, _n_pad(n), act_s, alv_s)
    want = ct._sort_key_plain(box, o_s.contiguous(), d_s.contiguous(), _n_pad(n),
                              act_s.contiguous(), alv_s.contiguous())
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_zero_lanes_launch_nothing(cuda, fresh):
    box, o, d, _, _ = key_lanes(0, seed=9, device="cuda")
    with metrics.recording(), metrics.span("trace.order", route="kernel", n=0):
        assert ct.coherence_key60(box, o, d).shape == (0,)
    assert not metrics.kernel_launches("trace.order", "route")


@pytest.mark.gpu
def test_kernel_route_torch_calls(cuda, fresh):
    """A kernel-route _coherence_order with `active` costs at most 16
    top-level torch calls (the allocation, the pointers and strides, the
    sort) where the plain twin costs over 100."""
    box, o, d, active, _ = key_lanes(4096, seed=10, device="cuda")
    ct._coherence_order(box, o, d, 4096, active)  # the build
    kernel = count_ops(lambda: ct._coherence_order(box, o, d, 4096, active))
    plain = count_ops(lambda: torch.sort(ct._sort_key_plain(box, o, d, 4096, active),
                                         stable=True))
    print(f"top-level torch calls per _coherence_order: kernel {kernel}, plain {plain}")
    assert sum(kernel.values()) <= 16 and sum(plain.values()) > 100
    assert ct.COHERENCE_KERNEL.build_info is not None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CLUSTER_CELLS)
def test_cell_path_bit_equal_to_the_plain_route(cuda, fresh, monkeypatch, cell):
    """One call of each cluster-tracer cell's path at a small size gives the
    film of the same call with the key's plain route forced, bit for bit;
    every `trace.order` span of the first took the kernel, one launch each,
    and none of the second launched.  BDPT sorts no wavefront of 32,768
    lanes or fewer (SMALL_WAVEFRONT): its frame is 256^2, where the shadow
    batch is sorted."""
    size = {"bench_100k.batch": 16, "veach.bdpt": 256}.get(cell, 32)
    prog, wl, _ = _program(cell, size, "cuda")
    n = {"veach.pt_nee": 2, "veach.bdpt": 1}.get(cell, wl["frames_per_call"])
    with metrics.recording():
        got = prog.call(prog.new_film(11), n)[0].hdr
    torch.cuda.synchronize()
    orders = [r for r in metrics.spans() if r.name == "trace.order"]
    assert orders and all(r.attrs["route"] == "kernel" for r in orders)
    assert all(r.launched == int(r.attrs["n"] > 0) for r in orders)
    metrics.clear_spans()
    monkeypatch.setattr(ct, "key_route", lambda x: "plain")
    with metrics.recording():
        want = prog.call(prog.new_film(11), n)[0].hdr
    assert not metrics.kernel_launches("trace.order", "route")
    assert torch.equal(got, want) and float(want.abs().sum()) > 0
