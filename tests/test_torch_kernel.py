"""The CUDA cluster kernel (ti_raytrace_tpu_torch/csrc/cluster_trace.cu)
against its plain PyTorch version, and the wrapper's input checks.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_kernel.py -m gpu --noconftest -p no:cacheprovider

(--noconftest: tests/conftest.py configures JAX).  Without a card the
`gpu` tests skip: a CUDA kernel has no CPU mode.  The kernel is compiled
with -fmad=false and keeps the plain version's operation order, so the
two must agree bit for bit, visited counts included.  Besides the real
scenes, a synthetic strip scene (`_strip_scene`) holds the cases the
kernel's design has to get right: ties split across the lanes of one warp
and across two clusters, a tile with one candidate ray, tiles that enter
no supercluster, parked lanes, padding clusters, a cluster count that is
not a multiple of the kernel's 128-position chunk, per-lane tmax and
capped wavefronts.  On the CPU the same cases check the plain version's
own answers (the tie rule, misses, visited counts).
"""

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.io.assets import asset_path
from ti_raytrace_tpu_torch.ops import cluster_trace as ct
from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder, sphere_shape
from ti_raytrace_tpu_torch.scene.data import device_scene

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """Skips the test without a card: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")


@pytest.fixture(scope="module")
def host():
    """The Teapot (25,200 tris) + sphere light, built by the port."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/Teapot.obj"))
    b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0), MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
    return b.build_host()


def _rays(host, n, seed, shared):
    rng = np.random.default_rng(seed)
    lo, hi = host["aabb_min"], host["aabb_max"]
    c, span = 0.5 * (lo + hi), hi - lo
    r = float(np.linalg.norm(span))
    if shared:
        o = np.repeat((c + np.array([0.3, 0.5, 1.0]) * r * 0.8)[:, None], n, axis=1)
    else:
        o = (c + rng.normal(size=(n, 3)) * r * np.where(np.arange(n) % 2, 0.8, 0.05)[:, None]).T
    d = c[:, None] + rng.normal(size=(3, n)) * span[:, None] * 0.3 - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))


def _kernel_inputs(scene, o, d, shared):
    origin = o[:, 0].contiguous() if shared else None
    return ct.kernel_inputs(scene, o, d, sort_rays=False, shared_origin=origin,
                            tile_order=not shared)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("shared", [True, False], ids=["camera", "deep"])
def test_kernel_matches_plain_on_cuda(host, shared, cuda, monkeypatch):
    """The kernel, by one launch of 5,000 live lanes on the card, equals
    the plain version lane for lane."""
    scene = device_scene(host, "cuda")
    o, d = _rays(host, 5000, 7, shared)  # 20 tiles, the last one partial
    args = _kernel_inputs(scene, o.cuda(), d.cuda(), shared)
    launches, launch = [], ct.KERNEL.launch

    def recorded(entry, device, *a):
        launches.append((entry, device.type, a[4]))  # a[4]: n_valid
        launch(entry, device, *a)

    monkeypatch.setattr(ct.KERNEL, "launch", recorded)
    got = ct.KERNEL(*args)
    torch.cuda.synchronize()
    assert launches == [("cluster_trace_launch", "cuda", 5000)]
    want = ct.cluster_trace_plain(*args)
    assert int((want[1] >= 0).sum()) > 500
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
def test_kernel_matches_plain_on_sorted_veach_wavefront(cuda):
    """The sorted mode's operands on the Veach scene (bdpt.obj with smooth
    normals): incoherent rays from inside the box, every 7th parked at
    1e9, coherence-sorted, per-tile order from the sorted tiles."""
    from ti_raytrace_tpu_torch.examples.scenes import veach_host

    host = veach_host()
    scene = device_scene(host, "cuda")
    rng = np.random.default_rng(5)
    lo, hi = host["aabb_min"], host["aabb_max"]
    o = lo + rng.random((6000, 3)) * (hi - lo)
    d = lo + rng.random((6000, 3)) * (hi - lo) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[::7] = 1e9
    o, d = (torch.from_numpy(x.T.astype(np.float32)).cuda() for x in (o, d))
    args, perm = ct.kernel_inputs(scene, o, d, sort_rays=True)
    assert perm is not None and args[4].shape[0] == args[0].shape[1] // ct.TILE
    got = ct.KERNEL(*args)
    torch.cuda.synchronize()
    want = ct.cluster_trace_plain(*args)
    assert int((want[1] >= 0).sum()) > 4000
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _veach_shadow_wavefront(scene, host, n, seed):
    """BDPT-like shadow rays on the Veach scene: incoherent rays from
    inside the box, every 7th parked at 1e9 with the 1e-3 bound, a third
    bounded short of their closest hit, the rest just past it (on the
    scene's device); returns (o, d, tmax)."""
    rng = np.random.default_rng(seed)
    lo, hi = host["aabb_min"], host["aabb_max"]
    o = lo + rng.random((n, 3)) * (hi - lo)
    d = lo + rng.random((n, 3)) * (hi - lo) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[::7] = 1e9
    o, d = (torch.from_numpy(x.T.astype(np.float32)).to(scene.device) for x in (o, d))
    t, _, _ = ct.trace_clustered(scene, o, d, sort_rays=True, sort_small=True)
    short = torch.from_numpy(rng.random(n) < 0.33).to(scene.device)
    tmax = torch.where(short, t * 0.5, torch.clamp(t, max=100.0) * 1.001 + 1e-3)
    tmax[::7] = 1e-3
    return o, d, tmax


@pytest.mark.gpu
def test_kernel_matches_plain_with_tmax_on_sorted_veach_wavefront(cuda):
    """The sorted mode's operands with a per-lane tmax (BDPT's shadow
    batch): bit-equal to the plain version, and lanes bounded short of
    their hit come back as t == tmax, prim == -1."""
    from ti_raytrace_tpu_torch.examples.scenes import veach_host

    host = veach_host()
    scene = device_scene(host, "cuda")
    o, d, tmax = _veach_shadow_wavefront(scene, host, 6000, 6)
    args, perm = ct.kernel_inputs(scene, o, d, sort_rays=True, tmax=tmax)
    assert args[7] is not None and torch.equal(args[7][:6000], tmax[perm[:6000]])
    got = ct.KERNEL(*args)
    torch.cuda.synchronize()
    want = ct.cluster_trace_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    bounded = (args[7] > 0) & (got[1] < 0)
    assert int(bounded.sum()) > 1000
    assert torch.equal(got[0][bounded], args[7][bounded])


@pytest.mark.gpu
def test_capped_trace_matches_cpu(cuda):
    """trace_clustered with tmax + active + cap_frac (sorted, with a cap
    that cuts active lanes) on CUDA equals the same trace on the CPU
    (plain version) lane for lane; on CUDA its one `trace.kernel` span
    launched the kernel at the capacity."""
    from ti_raytrace_tpu_torch import metrics
    from ti_raytrace_tpu_torch.examples.scenes import veach_host

    host = veach_host()
    out = {}
    for dev in ("cuda", "cpu"):
        scene = device_scene(host, dev)
        o, d, tmax = _veach_shadow_wavefront(scene, host, 40000, 8)
        active = torch.from_numpy(np.random.default_rng(3).random(40000) < 0.6).to(dev)
        metrics.clear_spans()
        with metrics.recording():
            out[dev] = ct.trace_clustered(scene, o, d, tmax=tmax, active=active, cap_frac=0.5)
        if dev == "cuda":
            assert sum(metrics.kernel_launches("trace.kernel", "n_valid").values()) == 1
            (span,) = [r for r in metrics.spans() if r.name == "trace.kernel"]
            assert span.attrs["n_pad"] == 20224
        metrics.clear_spans()
    assert ct.capacity_lanes(40000, 0.5) == 20224
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert int((out["cpu"][1] >= 0).sum()) > 5000


@pytest.mark.parametrize("bad", ["dtype", "shape", "order", "device", "tmax", "supers",
                                 "no_supers"])
def test_kernel_wrapper_rejects_bad_inputs(host, monkeypatch, bad):
    """The wrapper checks device, dtype, shape and contiguity before any
    build or launch, the tmax operand's too."""
    scene = device_scene(host, "cpu")
    o, d = _rays(host, 300, 1, False)
    args = list(_kernel_inputs(scene, o, d, False))
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[1] = args[1][:, :256].contiguous()
    elif bad == "order":
        args[4] = args[4][:1, :64].contiguous()
    elif bad == "tmax":
        args[7] = torch.ones(300)
    elif bad == "supers":
        args[8] = args[8][:, :1].contiguous()
    elif bad == "no_supers":
        args[8] = None
    else:
        args[5] = args[5].to("meta")
    monkeypatch.setattr(ct.KERNEL, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="cluster_trace"):
        ct.KERNEL(*args)


def test_plain_version_finds_closest_hits(host):
    """The plain version against a brute-force Moller-Trumbore over every
    triangle (float64): the same closest t on every lane."""
    scene = device_scene(host, "cpu")
    o, d = _rays(host, 200, 3, False)
    t, prim, _, _, _ = ct.cluster_trace_plain(*_kernel_inputs(scene, o, d, False))
    t, prim = t[:200].numpy(), prim[:200].numpy()
    v0 = host["tri_v0"][:-1].astype(np.float64)
    e1 = host["tri_e1"][:-1].astype(np.float64)
    e2 = host["tri_e2"][:-1].astype(np.float64)
    od, dd = o.numpy().T.astype(np.float64), d.numpy().T.astype(np.float64)
    p = np.cross(dd[:, None, :], e2[None])
    det = np.einsum("tk,rtk->rt", e1, p)
    tv = od[:, None, :] - v0[None]
    u = np.einsum("rtk,rtk->rt", tv, p) / det
    q = np.cross(tv, e1[None])
    v = np.einsum("rk,rtk->rt", dd, q) / det
    tt = np.einsum("tk,rtk->rt", e2, q) / det
    ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
    best = np.where(ok, tt, np.inf).min(axis=1)
    hit = np.isfinite(best)
    assert hit.sum() > 50
    np.testing.assert_array_equal(prim >= 0, hit)
    np.testing.assert_allclose(t[hit], best[hit], rtol=1e-4)


def test_kernel_build_hygiene(tmp_path, monkeypatch):
    """ops/cuda_build with a stand-in nvcc: a library is named by the hash
    of its source and reused while the source is unchanged (with nvcc's
    log kept beside it, or an empty log once that is gone), an edited
    source is rebuilt under a new name, and nvcc's own error text is
    raised.  The real build directory is one .gitignore lists."""
    import os
    import stat
    import sys

    from ti_raytrace_tpu_torch.ops import cuda_build

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.relpath(cuda_build.BUILD_DIR, repo) == os.path.join(".cache", "torch_kernels")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".cache/" in f.read().split()

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "src, out = args[-1], args[args.index('-o') + 1]\n"
        "if 'BROKEN' in open(src).read():\n"
        "    sys.stderr.write(src + '(2): error: expected a \";\"\\n')\n"
        "    sys.exit(2)\n"
        "sys.stderr.write('ptxas info    : Used 8 registers\\n')\n"
        "open(out, 'w').write('built from ' + src)\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path / "csrc"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"

    src.write_text("int x;\n")
    first = cuda_build.build("k.cu")
    assert first.built and os.path.isfile(first.path)
    assert os.path.dirname(first.path) == str(tmp_path / "build")
    again = cuda_build.build("k.cu")
    assert not again.built and again.path == first.path
    assert "Used 8 registers" in first.log and again.log == first.log
    os.remove(first.path[:-3] + ".log")
    bare = cuda_build.build("k.cu")
    assert not bare.built and bare.path == first.path and bare.log == ""

    src.write_text("int y;\n")
    edited = cuda_build.build("k.cu")
    assert edited.built and edited.path != first.path

    src.write_text("BROKEN\n")
    with pytest.raises(RuntimeError, match='error: expected a ";"'):
        cuda_build.build("k.cu")


# ------------------------------------------------- synthetic edge cases

STRIP_REAL, STRIP_CLUSTERS = 150, 160  # 10 padding clusters; C % 128 != 0
TIE_A, TIE_B = (5, 37, 77), (128 + 3, 256 + 3)  # slots holding one triangle


def _strip_scene(dev):
    """Cluster c < STRIP_REAL holds 128 small random triangles in the cell
    x in [c, c+1), y and z in [0, 1), so each supercluster (32 clusters) is
    a contiguous run of the strip; the last 10 clusters are padding
    (validity 0, -1 prim ids).  Prim id = slot.  Slots TIE_A (cluster 0:
    two slots in one lane of the kernel's warp, one in another lane) hold
    one triangle, and slot 3 of clusters 1 and 2 (TIE_B) another, both at
    z = 1.2, above the rest."""
    from types import SimpleNamespace

    rng = np.random.default_rng(11)
    P, real = STRIP_CLUSTERS * ct.CLUSTER_B, STRIP_REAL * ct.CLUSTER_B
    v0, e1, e2 = (np.zeros((P, 3), np.float32) for _ in range(3))
    cell = np.arange(real) // ct.CLUSTER_B
    v0[:real] = np.stack([cell + rng.random(real) * 0.8, rng.random(real) * 0.8,
                          rng.random(real) * 0.8], axis=1)
    e1[:real] = rng.normal(size=(real, 3)) * 0.15
    e2[:real] = rng.normal(size=(real, 3)) * 0.15
    for slots, x in ((TIE_A, 0.2), (TIE_B, 1.6)):
        for j in slots:
            v0[j], e1[j], e2[j] = (x, 0.2, 1.2), (0.3, 0.0, 0.0), (0.0, 0.3, 0.0)
    pid = np.where(np.arange(P) < real, np.arange(P), -1).astype(np.float32)
    tri = np.zeros((12, P), np.float32)
    tri[0:3], tri[3:6], tri[6:9], tri[9] = v0.T, e1.T, e2.T, pid
    vs = np.stack([v0, v0 + e1, v0 + e2])[:, :real].reshape(3, STRIP_REAL, ct.CLUSTER_B, 3)
    cb = np.zeros((8, STRIP_CLUSTERS), np.float32)
    cb[0:3], cb[3:6] = 1e30, -1e30
    cb[0:3, :STRIP_REAL] = vs.min(axis=(0, 2)).T
    cb[3:6, :STRIP_REAL] = vs.max(axis=(0, 2)).T
    cb[6, :STRIP_REAL] = 1.0
    cb, tri = torch.from_numpy(cb).to(dev), torch.from_numpy(tri).to(dev)
    return SimpleNamespace(cluster_bounds=cb, cluster_tri=tri,
                           super_bounds=ct.super_table(cb),
                           aabb_min=cb[0:3, :STRIP_REAL].amin(dim=1),
                           aabb_max=cb[3:6, :STRIP_REAL].amax(dim=1))


def _down(n, rng, x0, x1):
    """Rays from z = 3 straight down onto x in [x0, x1), y in [0, 0.8)."""
    o = np.stack([x0 + rng.random(n) * (x1 - x0), rng.random(n) * 0.8, np.full(n, 3.0)])
    d = np.tile(np.array([[0.0], [0.0], [-1.0]]), (1, n))
    return o, d


def _edge_case(case, dev):
    """(kernel operands, lane groups) of one edge case on the strip scene."""
    rng = np.random.default_rng(sum(map(ord, case)))
    scene = _strip_scene(dev)
    kw = {}
    groups = {}
    if case in ("ties_static", "ties_tile"):
        # 300 lanes over the two tied triangles (the last tile partial)
        oa, da = _down(150, rng, 0.21, 0.3)
        ob, db = _down(150, rng, 1.61, 1.7)
        o, d = np.concatenate([oa, ob], 1), np.concatenate([da, db], 1)
        o[1] = 0.21 + rng.random(300) * 0.08  # inside both triangles' y range
        groups = {"A": np.arange(150), "B": np.arange(150, 300)}
        kw = dict(tile_order=case == "ties_tile")
    elif case == "one_candidate":
        # one shared origin; tile 0 looks up (misses) but for lane 17,
        # tile 1 looks down the strip
        src = np.array([40.5, 0.4, 3.0])
        tgt = np.stack([rng.random(512) * STRIP_REAL, rng.random(512) * 0.8,
                        rng.random(512) * 0.8])
        tgt[2, :256] = 6.0
        tgt[:, 17] = (40.4, 0.4, 0.4)
        o = np.repeat(src[:, None], 512, axis=1)
        d = tgt - o
        kw = dict(shared_origin=torch.tensor(src, dtype=torch.float32, device=dev))
        groups = {"tile0": np.arange(256), "lane17": np.array([17])}
    elif case == "miss_all":
        # tile 0 looks up from above the strip (enters no supercluster),
        # tile 1 grazes along it from x = -1 (enters many); static order
        oa, da = _down(256, rng, 0.0, STRIP_REAL)
        da = -da
        ob = np.stack([np.full(256, -1.0), rng.random(256) * 0.8, rng.random(256) * 0.8])
        db = np.stack([np.ones(256), rng.normal(size=256) * 0.002, rng.normal(size=256) * 0.002])
        o, d = np.concatenate([oa, ob], 1), np.concatenate([da, db], 1)
        groups = {"up": np.arange(256)}
    else:  # parked / tmax: rays between random points of the strip box
        n = 700
        o = np.stack([rng.random(n) * STRIP_REAL, rng.random(n), rng.random(n)])
        d = np.stack([rng.random(n) * STRIP_REAL, rng.random(n), rng.random(n)]) - o
        o[:, ::7] = 1e9
        groups = {"parked": np.arange(0, n, 7)}
        kw = dict(tile_order=True)
        if case == "tmax":
            t_free = ct.cluster_trace_plain(*ct.kernel_inputs(
                _strip_scene("cpu"), torch.from_numpy(o.astype(np.float32)),
                torch.from_numpy((d / np.linalg.norm(d, axis=0)).astype(np.float32)),
                sort_rays=False, tile_order=True)[0])[0][:n].numpy()
            tmax = np.where(np.arange(n) % 3 == 0, t_free * 0.5, t_free * 1.01 + 1e-3)
            tmax[::7] = 1e-3
            kw = dict(sort_rays=True, tmax=torch.from_numpy(tmax.astype(np.float32)).to(dev))
            groups["short"] = np.setdiff1d(np.arange(0, n, 3), np.arange(0, n, 7))
            groups["t_free"] = t_free
    d = d / np.linalg.norm(d, axis=0, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (o, d))
    kw.setdefault("sort_rays", False)
    args, perm = ct.kernel_inputs(scene, o, d, **kw)
    return args, perm, groups


EDGE_CASES = ["ties_static", "ties_tile", "one_candidate", "miss_all", "parked", "tmax"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_version_on_edge_cases(case):
    """The plain version's own answers on the strip scene's edge cases:
    the tie rule (the first cluster in order with the least t, then the
    lowest slot), tiles with one or no candidate, parked lanes, bounds."""
    args, perm, g = _edge_case(case, "cpu")
    t, prim, _, _, visited = ct.cluster_trace_plain(*args)
    lane = (lambda i: i) if perm is None else (lambda i: torch.argsort(perm)[i].numpy())
    prim = prim.numpy()
    if case.startswith("ties"):
        assert (prim[g["A"]] == TIE_A[0]).all() and (prim[g["B"]] == TIE_B[0]).all()
        assert (t.numpy()[:300] < 3.0).all()
    elif case == "one_candidate":
        assert args[6] and (prim[g["tile0"]] >= 0).sum() == 1 and prim[17] >= 0
        assert visited[0] >= 1 and visited[1] > visited[0]
    elif case == "miss_all":
        assert (prim[g["up"]] == -1).all() and (prim >= 0).sum() > 100
        assert visited[0] == 0 and visited[1] > 0  # the up tile visits nothing
    else:
        assert (prim[lane(g["parked"])] == -1).all() and (prim >= 0).sum() > 200
        if case == "tmax":
            short = lane(g["short"])
            cut = g["t_free"][g["short"]] < 1e5
            assert cut.sum() > 50 and (prim[short][cut] == -1).all()
            assert torch.equal(t[short][cut], args[7][short][cut])


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_stats_count_the_work(case):
    """The plain version's work count for the bound
    (tools/kernel_wavefronts.bound): a candidate (ray, cluster) pair needs
    its ray to have entered the supercluster's box at the supercluster's
    start, so pairs <= 32 x super-box entries <= 32 x live lanes x S; the
    stats change no output, and a tile that looks away from the strip
    enters no super box."""
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import MT_OPS, SLAB_OPS, bound

    args, _, _ = _edge_case(case, "cpu")
    stats = {}
    got = ct.cluster_trace_plain(*args, stats=stats)
    for g, w in zip(got, ct.cluster_trace_plain(*args)):
        assert torch.equal(g, w)
    pairs, entries = int(stats["pairs"]), int(stats["super_entries"])
    n_valid, n_super = args[2], STRIP_CLUSTERS // ct.GROUP
    assert 0 < pairs <= ct.GROUP * entries <= ct.GROUP * n_valid * n_super
    ms, _, ops, _ = bound(args, pairs, entries)
    assert ops == (pairs * ct.CLUSTER_B * MT_OPS[bool(args[6])]
                   + (n_valid * n_super + ct.GROUP * entries) * SLAB_OPS) and ms > 0
    if case == "miss_all":  # tile 0 alone: every lane looks up, away from the strip
        o, d, _, b, order, tri, mt, tmax, sup = args
        up = {}
        ct.cluster_trace_plain(o[:, :ct.TILE], d[:, :ct.TILE], ct.TILE, b, order, tri, mt,
                               tmax, sup, stats=up)
        assert int(up["super_entries"]) == 0 and int(up["pairs"]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_matches_plain_on_edge_cases(case, cuda):
    """The kernel bit-equal to the plain version, visited counts included,
    on each edge case of the strip scene."""
    args, _, _ = _edge_case(case, "cuda")
    got = ct.KERNEL(*args)
    torch.cuda.synchronize()
    want = ct.cluster_trace_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
def test_capped_strip_trace_matches_cpu(cuda):
    """trace_clustered with tmax + active + a cap that cuts active lanes on
    the strip scene (padding clusters, C % 128 != 0): CUDA equals CPU."""
    out = {}
    for dev in ("cuda", "cpu"):
        args, _, _ = _edge_case("parked", dev)
        scene = _strip_scene(dev)
        scene.n_prims, scene.sphere_prims = STRIP_REAL * ct.CLUSTER_B, ()
        o, d = args[0][:, :700], args[1][:, :700]
        tmax = torch.full((700,), 50.0, device=dev)
        active = torch.from_numpy(np.random.default_rng(3).random(700) < 0.7).to(dev)
        out[dev] = ct.trace_clustered(scene, o, d, sort_small=True, tmax=tmax,
                                      active=active, cap_frac=0.4)
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert int((out["cpu"][1] >= 0).sum()) > 100
