"""The CUDA cluster kernel (ti_raytrace_tpu_torch/csrc/cluster_trace.cu)
against its plain PyTorch version, and the wrapper's input checks.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_kernel.py -m gpu --noconftest -p no:cacheprovider

(--noconftest: tests/conftest.py configures JAX).  Without a card the
`gpu` tests skip: a CUDA kernel has no CPU mode.  The kernel is compiled
with -fmad=false and keeps the plain version's operation order, so the
two must agree bit for bit.
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
def test_kernel_matches_plain_on_cuda(host, shared):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    scene = device_scene(host, "cuda")
    o, d = _rays(host, 5000, 7, shared)  # 20 tiles, the last one partial
    args = _kernel_inputs(scene, o.cuda(), d.cuda(), shared)
    before = ct.KERNEL.launches
    got = ct.KERNEL(*args)
    torch.cuda.synchronize()
    assert ct.KERNEL.launches == before + 1
    want = ct.cluster_trace_plain(*args)
    assert int((want[1] >= 0).sum()) > 500
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
def test_kernel_matches_plain_on_sorted_veach_wavefront():
    """The sorted mode's operands on the Veach scene (bdpt.obj with smooth
    normals): incoherent rays from inside the box, every 7th parked at
    1e9, coherence-sorted, per-tile order from the sorted tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
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
def test_kernel_matches_plain_with_tmax_on_sorted_veach_wavefront():
    """The sorted mode's operands with a per-lane tmax (BDPT's shadow
    batch): bit-equal to the plain version, and lanes bounded short of
    their hit come back as t == tmax, prim == -1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
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
def test_capped_trace_matches_cpu():
    """trace_clustered with tmax + active + cap_frac (sorted, with a cap
    that cuts active lanes) on CUDA equals the same trace on the CPU
    (plain version) lane for lane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    from ti_raytrace_tpu_torch.examples.scenes import veach_host

    host = veach_host()
    out = {}
    for dev in ("cuda", "cpu"):
        scene = device_scene(host, dev)
        o, d, tmax = _veach_shadow_wavefront(scene, host, 40000, 8)
        active = torch.from_numpy(np.random.default_rng(3).random(40000) < 0.6).to(dev)
        before = ct.KERNEL.launches
        out[dev] = ct.trace_clustered(scene, o, d, tmax=tmax, active=active, cap_frac=0.5)
        assert ct.KERNEL.launches == before + (dev == "cuda")
    assert ct.capacity_lanes(40000, 0.5) == 20224
    for g, w in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    assert int((out["cpu"][1] >= 0).sum()) > 5000


@pytest.mark.parametrize("bad", ["dtype", "shape", "order", "device", "tmax"])
def test_kernel_wrapper_rejects_bad_inputs(host, bad):
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
    else:
        args[5] = args[5].to("meta")
    before = ct.KERNEL.launches
    with pytest.raises(ValueError, match="cluster_trace"):
        ct.KERNEL(*args)
    assert ct.KERNEL.launches == before


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
    of its source and reused while the source is unchanged, an edited
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

    src.write_text("int y;\n")
    edited = cuda_build.build("k.cu")
    assert edited.built and edited.path != first.path

    src.write_text("BROKEN\n")
    with pytest.raises(RuntimeError, match='error: expected a ";"'):
        cuda_build.build("k.cu")
