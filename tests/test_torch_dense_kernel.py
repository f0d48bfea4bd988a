"""The dense sweep's CUDA kernel (ti_raytrace_tpu_torch/csrc/dense_trace.cu)
and what surrounds it in ops/dense_trace.py: the packed prim table
(`dense_table`), the wrapper (`DENSE_KERNEL`) and the dispatch of
`trace_planar`.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_dense_kernel.py -m gpu --noconftest -p no:cacheprovider

The CPU cases hold the table and the wrapper's checks, and run the
kernel's arithmetic over the table (`table_sweep`, a numpy transcript of
the kernel: float32, every product rounded, the kernel's operation order)
against the plain sweep `_sweep`: prims equal, t bit for bit but on
sphere hits.  There t may differ by the error of one square root:
torch.sqrt on CPU float32 tensors (AVX512 here) is not IEEE.  It is one
ulp off on ~0.8% of lanes, and in some processes its first calls return
a ~12-bit approximation: relative error up to 2.2e-4 on 615 of 2,400
lanes, the next call on the same input exact.  numpy's, CUDA's and the
kernel's sqrt are IEEE.  So a sphere hit is held to 2^-11 of the root
over the denominator plus two ulps of t, which the near root's
cancellation can make a few parts in ten thousand of t.  The `gpu` cases launch the kernel and hold it against
`_sweep` on the same CUDA tensors with `torch.equal` on t and prim: no
tolerance, the kernel is written to the plain version's bits.
"""

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import dense_trace as dt
from ti_raytrace_tpu_torch.scene.build import (MaterialRec, SceneBuilder, laser_shape,
                                               sphere_shape)
from ti_raytrace_tpu_torch.scene.data import device_scene

torch.set_num_threads(2)

GRAY = MaterialRec(C.MAT_DISNEY, color=(0.5, 0.5, 0.5), p1=0.5)
LIGHT = MaterialRec(C.MAT_LIGHT, color=(5.0, 5.0, 5.0))


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def row_scene(n, copies=(), shapes=False, degenerate=0):
    """A host dict of n triangles in the z = 0 plane, disjoint in a row
    along x, with the triangle over x in [0, 1] repeated at the prim
    indices `copies` (coincident: a ray through it hits every copy at one
    t); the first `degenerate` of the others collapsed to a segment;
    `shapes` adds a sphere light of radius 1 at (0.5, 0.25, 4) and a laser
    after the triangles."""
    pos = np.zeros((n, 3, 3), np.float32)
    for i in range(n):
        x0 = 0.0 if i in copies else 2.0 + 2.0 * i
        pos[i] = [[x0, 0.0, 0.0], [x0 + 1.0, 0.0, 0.0], [x0, 1.0, 0.0]]
    others = [i for i in range(n) if i not in copies][:degenerate]
    pos[others, 2] = pos[others, 1]
    b = SceneBuilder()
    b.add_triangles(pos, np.zeros_like(pos), np.zeros((n, 3, 2), np.float32), GRAY)
    if shapes:
        b.add_shape(sphere_shape([0.5, 0.25, 4.0], 1.0), LIGHT)
        b.add_shape(laser_shape([0.5, 0.25, 9.0], [0.0, 0.0, -1.0], 0.1), LIGHT)
    return b.build_host()


def down_rays(n, seed=2, z=3.0):
    """Rays from height z straight down through the triangle over [0, 1]
    (and, with shapes, through the sphere above it), planar (3, n) f32."""
    rng = np.random.default_rng(seed)
    uv = rng.random((n, 2)) * 0.45 + 0.02  # inside the triangle
    o = np.stack([uv[:, 0], uv[:, 1], np.full(n, z)]).astype(np.float32)
    d = np.stack([np.zeros(n), np.zeros(n), -np.ones(n)]).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def mixed_rays(n, seed):
    """Rays of every case the sweep meets, planar (3, n) f32: down through
    the copies from above the sphere (the sphere nearer), from inside the
    sphere (its near root behind: the triangle beyond), from below every
    prim aimed away (all hits behind), random directions from around the
    row, zero directions and origins of 1e30 and 3e38 (products overflow
    to inf, differences to NaN)."""
    rng = np.random.default_rng(seed)
    k = n // 6
    o, d = np.zeros((3, n), np.float32), np.zeros((3, n), np.float32)
    o[:, :k] = [[0.3], [0.2], [6.0]]
    d[2, :k] = -1.0
    o[:, :k] += (rng.random((3, k)) * 0.2).astype(np.float32)
    o[:, k:2 * k] = [[0.5], [0.25], [4.2]]
    d[:, k:2 * k] = [[0.01], [0.02], [-1.0]]
    o[:, 2 * k:3 * k] = [[0.3], [0.2], [-1.0]]
    d[2, 2 * k:3 * k] = -1.0
    m = n - 5 * k
    o[:, 3 * k:3 * k + m] = (rng.random((3, m)) * [[20.0], [2.0], [8.0]]
                             - [[2.0], [0.5], [2.0]]).astype(np.float32)
    v = rng.normal(size=(3, m))
    d[:, 3 * k:3 * k + m] = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    o[:, 3 * k + m:4 * k + m] = [[0.3], [0.2], [3.0]]  # d = 0
    o[:, 4 * k + m:] = [[1e30], [-3e38], [3e38]]
    d[:, 4 * k + m:] = [[0.6], [0.0], [-0.8]]
    return torch.from_numpy(o), torch.from_numpy(d)


def table_sweep(table, o, d):
    """The kernel's arithmetic in numpy float32: every lane against every
    row in index order, `csrc/dense_trace.cu` line by line (one product or
    sum per step, each rounded to float32).  Returns (t, prim, slack):
    slack is zero but on a sphere hit, where it bounds the plain CPU
    sweep's t by 2^-11 of its square root over the denominator plus two
    ulps of t (see the module's docstring)."""
    f = np.float32
    tab = table.numpy()
    ox, oy, oz = (o[i].numpy()[None, :] for i in range(3))
    dx, dy, dz = (d[i].numpy()[None, :] for i in range(3))
    col = [tab[:, k][:, None] for k in range(dt.TABLE_W)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, kind, cx, cy, cz, rad = col[:14]
    with np.errstate(all="ignore"):
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = (e1x * px + e1y * py) + e1z * pz
        s = np.where(det > 0, f(1), np.where(det < 0, f(-1), f(0)))
        adet = np.abs(det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = ((tx * px + ty * py) + tz * pz) * s
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = ((dx * qx + dy * qy) + dz * qz) * s
        tt = ((e2x * qx + e2y * qy) + e2z * qz) * s
        ok = (adet > f(1e-12)) & (u >= 0) & (u <= adet) & (v >= 0) & (u + v <= adet)
        t_tri = np.where(ok, tt * (f(1) / np.where(ok, adet, f(1))), f(C.INF))
        a = (dx * dx + dy * dy) + dz * dz
        a2 = f(2) * np.where(a < f(1e-12), f(1e-12), a)
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        oc2 = (ocx * ocx + ocy * ocy) + ocz * ocz
        dop = (dx * ocx + dy * ocy) + dz * ocz
        disc2 = oc2 - dop * dop
        b = f(-2) * dop
        cc = oc2 - rad * rad
        discr = b * b - (f(4) * a) * cc
        discr = np.where(discr < 0, f(0), discr)
        sq = np.sqrt(discr)
        t_sph = (-b - sq) / a2
        t_sph = np.where(disc2 < rad * rad, t_sph, f(C.INF))
        sphere = kind == dt.KIND_SPHERE
        t = np.where(kind == dt.KIND_TRI, t_tri, np.where(sphere, t_sph, f(C.INF)))
        t = np.where(t > 0, t, f(C.INF)).astype(f)
        slack = np.where(sphere & (t < f(C.INF)),
                         2.0 ** -11 * sq / a2 + 2.0 * np.spacing(np.abs(t)), 0.0)
    best_t = np.full(t.shape[1], f(C.INF))
    best_p = np.full(t.shape[1], -1, np.int32)
    best_s = np.zeros(t.shape[1])
    for p in range(t.shape[0]):  # strict <, in index order
        closer = t[p] < best_t
        best_t = np.where(closer, t[p], best_t)
        best_p = np.where(closer, np.int32(p), best_p)
        best_s = np.where(closer, slack[p], best_s)
    return torch.from_numpy(best_t), torch.from_numpy(best_p), torch.from_numpy(best_s)


def assert_table_sweep_matches(scene, o, d):
    """`table_sweep` over dense_table(scene) against `_sweep` on CPU
    tensors: prims equal, t bit-equal but within the slack on sphere
    hits.  Returns the plain sweep's prims."""
    t_k, p_k, slack = table_sweep(dt.dense_table(scene), o, d)
    t_p, p_p = dt._sweep(scene, o, d)
    assert torch.equal(p_k, p_p)
    exact = slack == 0
    assert torch.equal(t_k[exact], t_p[exact])
    assert bool(((t_k - t_p).abs().double() <= slack)[~exact].all())
    return p_p


# ------------------------------------------------------------------ CPU


def test_dense_table_rows_follow_the_scene():
    """prism_rainbow (3,152 triangles, then a sphere light and a laser):
    triangle rows carry v0, e1, e2 and KIND_TRI, the sphere KIND_SPHERE
    with its centre and radius, the laser KIND_NONE; cornell_box (no
    shapes): every row a triangle, zero shape columns."""
    from ti_raytrace_tpu_torch.examples.scenes import cornell_box_host, prism_rainbow_host

    scene = device_scene(prism_rainbow_host(), "cpu")
    tab = dt.dense_table(scene)
    P = scene.n_prims
    assert tab.shape == (P, dt.TABLE_W) and tab.dtype == torch.float32 and tab.is_contiguous()
    assert torch.equal(tab[:, 0:9], torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2], 1))
    assert torch.equal(tab[:, 14:], torch.zeros(P, 2))
    tri = scene.prim_type == C.PRIM_TRI
    assert int(tri.sum()) == scene.n_tris == 3152 and bool((tab[tri, 9] == dt.KIND_TRI).all())
    (sphere, sid), = scene.sphere_prims
    assert int(scene.shape_type[sid]) == C.SHAPE_SPHERE and tab[sphere, 9] == dt.KIND_SPHERE
    assert tab[sphere, 10:14].tolist() == [0.0, 20.0, 0.0, 5.0]
    laser = next(p for p in range(scene.n_tris, P) if p != sphere)
    lid = int(scene.prim_vidx[laser])
    assert int(scene.shape_type[lid]) == C.SHAPE_LASER and tab[laser, 9] == dt.KIND_NONE
    assert torch.equal(tab[laser, 10:13], scene.shape_pos[lid])
    assert tab[laser, 13] == scene.shape_param[lid, 0]

    box = device_scene(cornell_box_host(), "cpu")
    tab = dt.dense_table(box)
    assert tab.shape == (36, dt.TABLE_W) and bool((tab[:, 9] == dt.KIND_TRI).all())
    assert not tab[:, 10:].any()


@pytest.mark.parametrize("n_tris,copies", [(1, ()), (140, (3, 130)), (300, (127, 128, 299))],
                         ids=["one_prim", "two_blocks", "partial_block"])
def test_table_sweep_equals_plain_sweep(n_tris, copies):
    """The kernel's arithmetic over the packed table equals `_sweep`:
    triangles, a sphere, a laser, degenerate triangles, ties,
    rays from inside the sphere, hits only behind, zero and huge rays."""
    scene = device_scene(row_scene(n_tris, copies, shapes=True, degenerate=5), "cpu")
    assert scene.n_prims == n_tris + 2 and dt.scene_has_shapes(scene)
    o, d = mixed_rays(1200, 7)
    p_p = assert_table_sweep_matches(scene, o, d)
    assert 0 < int((p_p == n_tris).sum()) < 1200  # the sphere is hit
    if copies:
        assert int((p_p == min(copies)).sum()) > 100  # the lowest copy wins the tie


def test_table_sweep_equals_plain_sweep_on_prism():
    """prism_rainbow's 3,154 prims (a partial last block holding the
    sphere and the laser) on rays from its camera distance and at its
    lights: table and plain sweep agree."""
    from ti_raytrace_tpu_torch.examples.scenes import prism_rainbow_host

    scene = device_scene(prism_rainbow_host(), "cpu")
    rng = np.random.default_rng(3)
    n = 512
    o = np.repeat(np.array([[0.0], [1.0], [10.0]], np.float32), n, 1)
    tgt = (rng.random((3, n)) - 0.5) * [[4.0], [4.0], [4.0]]
    tgt[:, ::4] = [[0.0], [20.0], [0.0]]  # a quarter at the sphere light
    v = tgt - o
    d = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    p_p = assert_table_sweep_matches(scene, torch.from_numpy(o), torch.from_numpy(d))
    assert int((p_p == scene.sphere_prims[0][0]).sum()) > 50
    assert int(((p_p >= 0) & (p_p < scene.n_tris)).sum()) > 50


def test_trace_planar_on_cpu_takes_the_plain_sweep():
    """CPU tensors go to `_sweep`: no launch, the same bits; an unknown
    device raises rather than falling back."""
    scene = device_scene(row_scene(140, (3, 130), shapes=True), "cpu")
    o, d = mixed_rays(600, 1)
    dt.DENSE_KERNEL.reset_counts()
    t, prim = dt.trace_planar(scene, o, d)
    t_p, p_p = dt._sweep(scene, o, d)
    assert torch.equal(t, t_p) and torch.equal(prim, p_p)
    assert dt.DENSE_KERNEL.launches == 0
    with pytest.raises(NotImplementedError):
        dt.trace_planar(scene, o.to("meta"), d.to("meta"))


def test_kernel_wrapper_checks_raise():
    """Wrong dtype, shape, contiguity or device raise before any build or
    launch."""
    scene = device_scene(row_scene(4), "cpu")
    table = dt.dense_table(scene)
    o, d = down_rays(16)
    k = dt.DENSE_KERNEL
    k.reset_counts()
    with pytest.raises(ValueError, match="float32"):
        k(o.double(), d, table)
    with pytest.raises(ValueError, match="float32"):
        k(o, d, table.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        k(torch.cat([o, o], 1)[:, ::2], d, table)
    with pytest.raises(ValueError, match="shapes"):
        k(o[:2].contiguous(), d[:2].contiguous(), table)
    with pytest.raises(ValueError, match="shapes"):
        k(o, d[:, :8].contiguous(), table)
    with pytest.raises(ValueError, match="shapes"):
        k(o, d, table[:, :12].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        k(o, d, table)
    assert k.launches == 0 and k._lib is None


# ------------------------------------------------------------------ GPU


def _kernel_vs_plain(host, o, d):
    """Kernel and `_sweep` on the same CUDA tensors: equal bit for bit.
    Returns the kernel's (t, prim) on the CPU."""
    scene = device_scene(host, "cuda")
    o, d = o.cuda(), d.cuda()
    t_k, p_k = dt.DENSE_KERNEL(o, d, dt.dense_table(scene))
    t_p, p_p = dt._sweep(scene, o, d)
    torch.cuda.synchronize()
    assert t_k.shape == p_k.shape == (o.shape[1],) and p_k.dtype == torch.int32
    assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
    return t_k.cpu(), p_k.cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [(0, 4095), (127, 128), (255, 256), (128, 4095),
                                    (0, 127, 128, 255, 256, 4095)],
                         ids=["first_last", "tile_edge", "second_edge", "far_apart", "all"])
def test_ties_across_tile_edges(cuda, copies):
    """Coincident copies straddling the kernel's 128-row tiles in a
    4,096-prim scene: the lowest index wins, as in `_sweep`."""
    o, d = down_rays(1000)
    t, prim = _kernel_vs_plain(row_scene(4096, copies), o, d)
    assert bool((prim == min(copies)).all()) and bool((t == 3.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_prims", [1, 300, 4096])
@pytest.mark.parametrize("n_lanes", [1, 1000, 65536])
def test_prim_and_lane_counts(cuda, n_prims, n_lanes):
    """P = 1, P not a multiple of the tile, P = DENSE_MAX_PRIMS; N = 1, N
    not a multiple of 256, N = 65,536."""
    o, d = mixed_rays(max(n_lanes, 6), n_prims)
    o, d = o[:, :n_lanes].contiguous(), d[:, :n_lanes].contiguous()
    _kernel_vs_plain(row_scene(n_prims, (0,)), o, d)


@pytest.mark.gpu
def test_zero_lanes_launch_nothing(cuda):
    scene = device_scene(row_scene(8), "cuda")
    dt.DENSE_KERNEL.reset_counts()
    e = torch.empty((3, 0), device="cuda")
    t, prim = dt.DENSE_KERNEL(e, e, dt.dense_table(scene))
    assert t.shape == prim.shape == (0,) and prim.dtype == torch.int32
    t, prim = dt.trace_planar(scene, e, e)
    assert t.shape == (0,) and dt.DENSE_KERNEL.launches == 0


@pytest.mark.gpu
def test_shapes_degenerate_and_behind(cuda):
    """A sphere (rays from above it, from inside it), a laser (never hit),
    degenerate triangles, rays whose every hit lies behind them, zero and
    huge rays."""
    o, d = mixed_rays(6000, 11)
    t, prim = _kernel_vs_plain(row_scene(300, (0, 129), shapes=True, degenerate=40), o, d)
    k = 1000
    assert bool((prim[:k] == 300).all())             # the sphere, from above
    assert bool((prim[k:2 * k] == 0).all())          # from inside it: the copy below
    assert bool((prim[2 * k:3 * k] == -1).all())     # every hit behind
    assert bool((t[prim == -1] == C.INF).all())
    assert not bool((prim == 301).any())             # the laser is never hit


@pytest.mark.gpu
def test_single_model_camera_rays(cuda):
    """The 128^2 camera wavefront of single_model (2,280 triangles and the
    sphere light), through `trace_planar` as the renderer calls it."""
    from ti_raytrace_tpu_torch.camera import ray_directions_morton
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.examples.scenes import make_camera, single_model

    scene, cfg = single_model("cuda")
    spec, cam = make_camera(scene, cfg, 128, 128)
    d = ray_directions_morton(spec, cam, 1, rng.PRNGKey(4))
    o = cam.eye[:, None].expand(3, d.shape[1]).contiguous()
    dt.DENSE_KERNEL.reset_counts()
    t_k, p_k = dt.trace_planar(scene, o, d)
    assert dt.DENSE_KERNEL.launches == 1
    t_p, p_p = dt._sweep(scene, o, d)
    assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
    assert 2000 < int((p_k >= 0).sum()) < 128 * 128


@pytest.mark.gpu
def test_cuda_call_counts_a_launch(cuda):
    scene = device_scene(row_scene(140, (3, 130)), "cuda")
    o, d = (x.cuda() for x in down_rays(64))
    dt.DENSE_KERNEL.reset_counts()
    dt.trace_planar(scene, o, d)
    dt.trace_shaded(scene, o, d)
    assert dt.DENSE_KERNEL.launches == 2
    assert dt.DENSE_KERNEL.build_info is not None and dt.DENSE_KERNEL.build_info.path
