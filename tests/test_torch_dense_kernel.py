"""The dense sweep's CUDA kernel (ti_raytrace_tpu_torch/csrc/dense_trace.cu)
and what surrounds it in ops/dense_trace.py: the prim rows
(`dense_table`), the grouped table built once per scene (`dense_groups`:
triangles in morton order in groups of 32 with a padded box each, a
sphere tail), the wrapper (`DENSE_KERNEL`) and the dispatch of
`trace_planar`.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_dense_kernel.py -m gpu --noconftest -p no:cacheprovider

The CPU cases hold the tables and the wrapper's checks, and run the
kernel's arithmetic over the grouped table (`table_sweep`, a numpy
transcript of the kernel: float32, every product rounded, the kernel's
operation order; the slab test, the warp votes, the grazing guard and the
order-free tie rule) against the plain sweep `_sweep`: prims equal, t bit
for bit but on sphere hits.  The transcript also tests every row the cull
skipped and fails if one of them had a hit: the cull is exact on every
input here, not only where a skipped hit would have lost.  On a sphere
hit t may differ by the error of one square root: torch.sqrt on CPU
float32 tensors (AVX512 here) is not IEEE.  It is one
ulp off on ~0.8% of lanes, and in some processes its first calls return
a ~12-bit approximation: relative error up to 2.2e-4 on 615 of 2,400
lanes, the next call on the same input exact.  numpy's, CUDA's and the
kernel's sqrt are IEEE.  So a sphere hit is held to 2^-11 of the root
over the denominator plus two ulps of t, which the near root's
cancellation can make a few parts in ten thousand of t.  The `gpu`
cases launch the kernel and hold it against `_sweep` on the same CUDA
tensors with `torch.equal` on t and prim (no tolerance: the kernel is
written to the plain version's bits), and its (warp, group) counts
against the transcript's.
"""

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import dense_trace as dt
from ti_raytrace_tpu_torch.scene.build import (MaterialRec, SceneBuilder, laser_shape,
                                               sphere_shape)
from ti_raytrace_tpu_torch.utils.morton import morton3d
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


def _row_t(rows, o, d):
    """The kernel's row test in numpy float32: (R, N) t of rows x lanes,
    t > 0 else INF, and the sphere slack (see the module's docstring)."""
    f = np.float32
    ox, oy, oz = (o[i][None, :] for i in range(3))
    dx, dy, dz = (d[i][None, :] for i in range(3))
    col = [rows[:, k][:, None] for k in range(dt.TABLE_W)]
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
    return t, slack


def table_sweep(boxes, rows, o, d, guard=True):
    """The kernel in numpy float32 over the grouped table (dense_groups),
    `csrc/dense_trace.cu` line by line: per group the slab test, the vote
    of each warp (32 consecutive lanes; the dead lanes of the last block
    of 256 take no part), the grazing guard where no lane passed (its
    vote on the thinnest row's certain risk, then its loop over the rows
    and a vote; skipped with guard=False), the rows of the groups a warp
    tests,
    then the sphere tail, each row folded in by `t < best_t || (t ==
    best_t && id < best_id)`.  Returns (t, prim, slack, counts, culled):
    slack as `_row_t`'s, counts the kernel's (pairs tested, pairs
    guarded, pairs whose guard looped over the rows, and the real rows of
    the tested and of the looped pairs), culled the (lane, row) pairs the
    cull skipped that had a hit."""
    f = np.float32
    box, tab = boxes.numpy(), rows.numpy()
    o, d = o.numpy(), d.numpy()
    n = o.shape[1]
    ox, oy, oz = o
    dx, dy, dz = d
    warp = np.arange(n) // 32
    n_warps = -(-n // 256) * 8
    with np.errstate(all="ignore"):
        dn = np.sqrt((dx * dx + dy * dy) + dz * dz)
        ix, iy, iz = f(1) / dx, f(1) / dy, f(1) / dz
    best_t = np.full(n, f(C.INF))
    best_p = np.full(n, -1, np.int32)
    best_s = np.zeros(n)
    counts = np.zeros(5, np.int64)
    culled = 0

    def fold(t, slack, ids):
        for r in range(t.shape[0]):
            closer = (t[r] < best_t) | ((t[r] == best_t) & (ids[r] < best_p))
            best_t[:] = np.where(closer, t[r], best_t)
            best_p[:] = np.where(closer, ids[r], best_p)
            best_s[:] = np.where(closer, slack[r], best_s)

    def votes(lanes):
        return np.bincount(warp, weights=lanes, minlength=n_warps) > 0

    for g in range(box.shape[0]):
        lox, loy, loz, hix, hiy, hiz, cx, cy, cz, k0, k1, real, m_min = box[g, :13]
        grp = tab[dt.GROUP * g:dt.GROUP * g + int(real)]
        with np.errstate(all="ignore"):
            t1x, t2x = (lox - ox) * ix, (hix - ox) * ix
            t1y, t2y = (loy - oy) * iy, (hiy - oy) * iy
            t1z, t2z = (loz - oz) * iz, (hiz - oz) * iz
            tnear = np.maximum(np.maximum(np.minimum(t1x, t2x), np.minimum(t1y, t2y)),
                               np.minimum(t1z, t2z))
            tfar = np.minimum(np.minimum(np.maximum(t1x, t2x), np.maximum(t1y, t2y)),
                              np.maximum(t1z, t2z))
            reject = (tfar < 0) | (tnear > tfar * f(1.0 + 2.0 ** -20))
            run = votes(~reject)
            counts[1] += int((~run).sum())
            if guard:
                thr = dn * (k0 + k1 * ((np.abs(ox - cx) + np.abs(oy - cy)) + np.abs(oz - cz)))
                certain = ~run & votes(thr > dn * m_min)
                loop = ~run & ~certain
                counts[2] += int(loop.sum())
                counts[4] += int(loop.sum()) * int(real)
                dot = (dx[None, :] * grp[:, 10:11] + dy[None, :] * grp[:, 11:12]) \
                    + dz[None, :] * grp[:, 12:13]
                run |= certain | (loop & votes((np.abs(dot) < thr[None, :]).any(axis=0)))
        counts[0] += int(run.sum())
        counts[3] += int(run.sum()) * int(real)
        t, slack = _row_t(grp, o, d)
        skipped = ~run[warp]
        culled += int(((t < f(C.INF)) & skipped[None, :]).sum())
        fold(np.where(skipped[None, :], f(C.INF), t), slack, grp[:, 14].astype(np.int32))
    tail = tab[dt.GROUP * box.shape[0]:]
    t, slack = _row_t(tail, o, d)
    fold(t, slack, tail[:, 14].astype(np.int32))
    return (torch.from_numpy(best_t), torch.from_numpy(best_p), torch.from_numpy(best_s),
            tuple(int(c) for c in counts), culled)


def assert_table_sweep_matches(scene, o, d):
    """`table_sweep` over the scene's grouped table against `_sweep` on CPU
    tensors: no hit culled, prims equal, t bit-equal but within the slack
    on sphere hits.  Returns the plain sweep's prims and the transcript's
    counts."""
    t_k, p_k, slack, counts, culled = table_sweep(scene.dense_boxes, scene.dense_rows, o, d)
    t_p, p_p = dt._sweep(scene, o, d)
    assert culled == 0
    assert torch.equal(p_k, p_p)
    exact = slack == 0
    assert torch.equal(t_k[exact], t_p[exact])
    assert bool(((t_k - t_p).abs().double() <= slack)[~exact].all())
    return p_p, counts


def tilted_scene():
    """One triangle in a plane of no axis (normal ~(0.3, 0.5, 0.81)), as a
    host dict, and (v0, a, b): a vertex and two unit vectors spanning its
    plane, float64."""
    n = np.array([0.3, 0.5, 0.81])
    n /= np.linalg.norm(n)
    a = np.cross(n, [1.0, 0.0, 0.0])
    a /= np.linalg.norm(a)
    b = np.cross(n, a)
    v0 = 0.2 * a + 0.1 * b
    pos = np.stack([v0, v0 + 0.5 * a, v0 + 0.6 * a + 0.4 * b])[None].astype(np.float32)
    sb = SceneBuilder()
    sb.add_triangles(pos, np.zeros_like(pos), np.zeros((1, 3, 2), np.float32), GRAY)
    return sb.build_host(), (pos[0, 0].astype(np.float64), a, b)


def coplanar_rays(n, seed):
    """Rays lying in the tilted triangle's plane up to float32 rounding,
    from 2 to 6 units away, in directions whose lines pass at least 1.5
    units from the triangle's centroid: far outside its padded box, yet
    their Moller-Trumbore terms are rounding noise, so `_sweep` reports
    noise hits on some of them.  Planar (3, n) f32."""
    _, (v0, a, b) = tilted_scene()
    cen = v0 + (0.5 * a + 0.6 * a + 0.4 * b) / 3.0
    rng = np.random.default_rng(seed)
    os, ds = [], []
    while sum(len(x) for x in os) < n:
        m = 4 * n
        ang = rng.random(m) * 2 * np.pi
        r = 2.0 + 4.0 * rng.random(m)
        ang2 = rng.random(m) * 2 * np.pi
        o = (v0 + np.outer(r * np.cos(ang), a) + np.outer(r * np.sin(ang), b)).astype(np.float32)
        d = (np.outer(np.cos(ang2), a) + np.outer(np.sin(ang2), b)).astype(np.float32)
        w = cen - o
        perp = np.linalg.norm(w - (w * d).sum(1)[:, None] * d, axis=1)
        os.append(o[perp > 1.5])
        ds.append(d[perp > 1.5])
    o, d = np.concatenate(os)[:n], np.concatenate(ds)[:n]
    return torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())


def edge_rays(n_tris):
    """Rays at the edges of row_scene's triangles, planar (3, N) f32:
    straight down through each vertex and each edge's midpoint of the
    first min(n_tris, 64); grazing along the z = 0 plane that holds them
    (in it, and 1e-6 above it falling by 1e-7 per unit); from above at
    shallow angles across the row."""
    k = min(n_tris, 64)
    x0 = np.where(np.arange(k) == 0, 0.0, 2.0 + 2.0 * np.arange(k))
    pts = np.concatenate([np.stack([x0, np.zeros(k)], 1), np.stack([x0 + 1.0, np.zeros(k)], 1),
                          np.stack([x0, np.ones(k)], 1), np.stack([x0 + 0.5, np.zeros(k)], 1),
                          np.stack([x0 + 0.5, np.full(k, 0.5)], 1),
                          np.stack([x0, np.full(k, 0.5)], 1)])
    down_o = np.concatenate([pts, np.full((len(pts), 1), 3.0)], 1)
    down_d = np.tile([0.0, 0.0, -1.0], (len(pts), 1))
    ys = np.linspace(-0.25, 1.25, 64)
    graze_o = np.concatenate([np.stack([np.full(64, -3.0), ys, np.zeros(64)], 1),
                              np.stack([np.full(64, -3.0), ys, np.full(64, 1e-6)], 1)])
    graze_d = np.concatenate([np.tile([1.0, 0.0, 0.0], (64, 1)),
                              np.tile([1.0, 0.0, -1e-7], (64, 1))])
    xs = np.linspace(-1.0, 2.0 * k + 3.0, 128)
    shallow_o = np.stack([xs, np.full(128, 0.4), np.full(128, 0.05)], 1)
    shallow_d = np.tile([0.999, 0.01, -0.04], (128, 1))
    o = np.concatenate([down_o, graze_o, shallow_o]).astype(np.float32)
    d = np.concatenate([down_d, graze_d, shallow_d]).astype(np.float32)
    return torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())


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


def test_grouped_table_structure():
    """dense_groups on prism_rainbow (a sphere light and a laser after its
    triangles), cornell_box and a row with coincident copies: the triangle
    rows are a permutation of the triangle prims in morton order of their
    centroids, each with its prim id, its dense_table columns and m; the
    last group is padded with rows that never hit; each box contains its
    triangles padded by at least PAD_EXTENT of its extent and holds the
    guard's constants; the sphere rows follow as the tail; the laser is
    left out."""
    from ti_raytrace_tpu_torch.examples.scenes import cornell_box_host, prism_rainbow_host

    for host in (prism_rainbow_host(), cornell_box_host(), row_scene(300, tuple(range(0, 300, 7)))):
        scene = device_scene(host, "cpu")
        boxes, rows, table = scene.dense_boxes, scene.dense_rows, dt.dense_table(scene)
        tri = torch.nonzero(table[:, 9] == dt.KIND_TRI).squeeze(1)
        G = (tri.numel() + dt.GROUP - 1) // dt.GROUP
        assert boxes.shape == (G, dt.TABLE_W) and boxes.dtype == torch.float32
        assert boxes.is_contiguous() and rows.is_contiguous()
        body, tail = rows[:dt.GROUP * G], rows[dt.GROUP * G:]
        ids = body[:, 14].long()
        real = ids >= 0
        assert torch.equal(torch.sort(ids[real]).values, tri)
        assert int(real.sum()) == tri.numel() and bool(real[:tri.numel()].all())
        assert torch.equal(body[real][:, :10], table[ids[real], :10])
        pad = body[~real]
        assert bool((pad[:, 9] == dt.KIND_NONE).all()) and not pad[:, :14].any()
        v0, e1, e2 = (body[real][:, k:k + 3].double() for k in (0, 3, 6))
        m = torch.linalg.cross(e1, e2) / (e1.norm(dim=1) * e2.norm(dim=1))[:, None]
        assert torch.allclose(body[real][:, 10:13].double(), m, rtol=1e-6, atol=1e-7)
        cen = v0 + (e1 + e2) / 3.0
        lo, hi = cen.amin(dim=0), cen.amax(dim=0)
        code = morton3d(*((cen - lo) / torch.clamp(hi - lo, min=1e-30)).T)
        assert bool((code[1:] >= code[:-1]).all())
        verts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)
        group = torch.arange(tri.numel()) // dt.GROUP
        assert torch.equal(boxes[:, 11], torch.bincount(group, minlength=G).float())
        for g in range(G):
            vs = verts[group == g].reshape(-1, 3)
            vlo, vhi = vs.amin(dim=0), vs.amax(dim=0)
            pad_min = dt.PAD_EXTENT * float((vhi - vlo).max())
            assert bool((boxes[g, 0:3].double() <= vlo - pad_min).all())
            assert bool((boxes[g, 3:6].double() >= vhi + pad_min).all())
            r = float((vs - boxes[g, 6:9].double()).norm(dim=1).max())
            assert boxes[g, 9] > dt.NOISE * (1.0 + 8.0 * r / float((boxes[g, 3:6] - vhi).min()))
            assert boxes[g, 10] > 0.0 and not boxes[g, 13:].any()
            m_g = body[real][group == g][:, 10:13].double()
            assert boxes[g, 12] == m_g.norm(dim=1).min().float()
        spheres = [pid for pid, _ in scene.sphere_prims]
        assert tail[:, 14].long().tolist() == spheres
        assert torch.equal(tail[:, :14], table[spheres, :14])
        assert int((rows[:, 9] == dt.KIND_NONE).sum()) == G * dt.GROUP - tri.numel()


@pytest.mark.parametrize("n_tris,copies", [
    (1, ()), (140, (3, 130)), (300, (127, 128, 299)), (31, (0, 30)), (32, (0, 31)),
    (33, (0, 32)), (4094, (0, 1000, 2047, 4093)), (300, tuple(range(0, 300, 7)))],
    ids=["one_prim", "two_blocks", "partial_block", "31", "32", "33", "4096_prims",
         "ties_across_groups"])
def test_table_sweep_equals_plain_sweep(n_tris, copies):
    """The kernel's arithmetic over the grouped table equals `_sweep`, and
    the cull skips no hit: triangles, a sphere (hit from above, from
    inside it, and behind rays that leave), a laser, degenerate triangles,
    coincident copies (the lowest index wins; 43 copies span two groups),
    zero and huge rays."""
    scene = device_scene(row_scene(n_tris, copies, shapes=True, degenerate=5), "cpu")
    assert scene.n_prims == n_tris + 2 and dt.scene_has_shapes(scene)
    o, d = mixed_rays(1200, 7)
    p_p, (tested, guarded, looped, rows, looped_rows) = assert_table_sweep_matches(scene, o, d)
    assert 0 < int((p_p == n_tris).sum()) < 1200  # the sphere is hit
    if copies:
        assert int((p_p == min(copies)).sum()) > 100  # the lowest copy wins the tie
    groups = scene.dense_boxes.shape[0]
    assert 0 < tested <= 40 * groups and looped <= guarded <= 40 * groups  # 40 warps
    last = n_tris - dt.GROUP * (groups - 1)  # the last group's real rows
    assert tested * last <= rows <= tested * dt.GROUP
    assert looped * last <= looped_rows <= looped * dt.GROUP
    if len(copies) > dt.GROUP:
        gid = torch.nonzero(torch.isin(scene.dense_rows[:, 14].long(),
                                       torch.tensor(copies))).squeeze(1) // dt.GROUP
        assert gid.unique().numel() == 2


def test_table_sweep_equals_plain_sweep_on_prism():
    """prism_rainbow's 3,154 prims (99 groups and a sphere tail; its laser
    left out) on rays from its camera distance and at its lights: table
    and plain sweep agree, and the cull skips no hit."""
    from ti_raytrace_tpu_torch.examples.scenes import prism_rainbow_host

    scene = device_scene(prism_rainbow_host(), "cpu")
    rng = np.random.default_rng(3)
    n = 512
    o = np.repeat(np.array([[0.0], [1.0], [10.0]], np.float32), n, 1)
    tgt = (rng.random((3, n)) - 0.5) * [[4.0], [4.0], [4.0]]
    tgt[:, ::4] = [[0.0], [20.0], [0.0]]  # a quarter at the sphere light
    v = tgt - o
    d = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    p_p, (tested, _, _, rows, _) = assert_table_sweep_matches(scene, torch.from_numpy(o),
                                                           torch.from_numpy(d))
    assert int((p_p == scene.sphere_prims[0][0]).sum()) > 50
    assert int(((p_p >= 0) & (p_p < scene.n_tris)).sum()) > 50
    assert tested < 16 * scene.dense_boxes.shape[0]  # 16 warps: some groups culled
    assert rows < tested * dt.GROUP  # the last group holds fewer than 32


@pytest.mark.parametrize("n_tris", [1, 33, 300])
def test_edges_vertices_and_grazing(n_tris):
    """Rays through the vertices and edge midpoints of the row's triangles,
    rays grazing the plane that holds them (in it, and falling through it
    at 1e-7 per unit) and shallow rays across the row: the transcript
    equals `_sweep`, and skips no hit."""
    scene = device_scene(row_scene(n_tris, (0,), degenerate=2), "cpu")
    o, d = edge_rays(n_tris)
    p_p, _ = assert_table_sweep_matches(scene, o, d)
    assert int((p_p >= 0).sum()) > 6 * min(n_tris, 64) // 2


def test_coplanar_noise_hits_are_guarded():
    """A ray lying in a triangle's plane to within rounding: det, u, v and
    t are rounding noise, and `_sweep` reports noise hits on rays that
    pass far outside the triangle's padded box.  The slab test alone would
    cull them (guard=False: hits culled, a differing answer); the grazing
    guard tests them, and the transcript equals `_sweep`."""
    host, _ = tilted_scene()
    scene = device_scene(host, "cpu")
    o, d = coplanar_rays(4096, 5)
    t_p, p_p = dt._sweep(scene, o, d)
    noise = p_p == 0
    assert int(noise.sum()) > 10  # noise hits, every one outside the box
    box = scene.dense_boxes[0]
    hit = o[:, noise] + t_p[noise] * d[:, noise]
    assert bool(((hit < box[0:3, None]) | (hit > box[3:6, None])).any(dim=0).all())
    _, p_slab, _, (tested_slab, _, _, _, _), culled = table_sweep(
        scene.dense_boxes, scene.dense_rows, o, d, guard=False)
    assert culled > 0 and not torch.equal(p_slab, p_p) and tested_slab == 0
    _, (tested, guarded, looped, rows, looped_rows) = assert_table_sweep_matches(scene, o, d)
    assert guarded == looped == 128 and tested > 0
    real = int(scene.dense_boxes[0, 11])
    assert rows == tested * real and looped_rows == looped * real


def test_trace_planar_on_cpu_takes_the_plain_sweep():
    """CPU tensors go to `_sweep`: the same bits (that the CPU route loads
    no library is a case of tests/test_torch_launcher.py); an unknown
    device raises rather than falling back."""
    scene = device_scene(row_scene(140, (3, 130), shapes=True), "cpu")
    o, d = mixed_rays(600, 1)
    t, prim = dt.trace_planar(scene, o, d)
    t_p, p_p = dt._sweep(scene, o, d)
    assert torch.equal(t, t_p) and torch.equal(prim, p_p)
    with pytest.raises(NotImplementedError):
        dt.trace_planar(scene, o.to("meta"), d.to("meta"))


def test_kernel_wrapper_checks_raise(monkeypatch):
    """Wrong dtype, shape, contiguity or device raise before any build or
    launch."""
    scene = device_scene(row_scene(40), "cpu")
    boxes, rows = scene.dense_boxes, scene.dense_rows
    o, d = down_rays(16)
    k = dt.DENSE_KERNEL
    monkeypatch.setattr(k, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="float32"):
        k(o.double(), d, boxes, rows)
    with pytest.raises(ValueError, match="float32"):
        k(o, d, boxes, rows.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        k(torch.cat([o, o], 1)[:, ::2], d, boxes, rows)
    with pytest.raises(ValueError, match="shapes"):
        k(o[:2].contiguous(), d[:2].contiguous(), boxes, rows)
    with pytest.raises(ValueError, match="shapes"):
        k(o, d[:, :8].contiguous(), boxes, rows)
    with pytest.raises(ValueError, match="shapes"):
        k(o, d, boxes[:, :12].contiguous(), rows)
    with pytest.raises(ValueError, match="shapes"):
        k(o, d, boxes, rows[:40].contiguous())  # fewer rows than 32 per group
    with pytest.raises(ValueError, match="counts"):
        k(o, d, boxes, rows, counts=torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="counts"):
        k(o, d, boxes, rows, counts=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        k(o, d, boxes, rows)


def test_only_dense_scenes_carry_the_grouped_table():
    """The grouped table is built for scenes of at most DENSE_MAX_PRIMS
    prims, the dense tracer's; a larger scene carries it empty, as (0,
    TABLE_W) tensors."""
    from ti_raytrace_tpu_torch import accel

    n = accel.DENSE_MAX_PRIMS
    at = device_scene(row_scene(n), "cpu")
    assert at.dense_boxes.shape == (n // dt.GROUP, dt.TABLE_W)
    assert at.dense_rows.shape == (n, dt.TABLE_W)
    above = device_scene(row_scene(n + 1), "cpu")
    assert above.n_prims == n + 1
    for x in (above.dense_boxes, above.dense_rows):
        assert x.shape == (0, dt.TABLE_W) and x.dtype == torch.float32


# ------------------------------------------------------------------ GPU


def _kernel_vs_plain(host, o, d):
    """Kernel and `_sweep` on the same CUDA tensors: equal bit for bit,
    and the kernel's (warp, group) counts equal to the transcript's on
    the same rays.  Returns the kernel's (t, prim) on the CPU."""
    scene = device_scene(host, "cuda")
    o, d = o.cuda(), d.cuda()
    counts = torch.zeros(5, dtype=torch.int32, device="cuda")
    t_k, p_k = dt.DENSE_KERNEL(o, d, scene.dense_boxes, scene.dense_rows, counts)
    t_p, p_p = dt._sweep(scene, o, d)
    torch.cuda.synchronize()
    assert t_k.shape == p_k.shape == (o.shape[1],) and p_k.dtype == torch.int32
    assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
    *_, want, culled = table_sweep(scene.dense_boxes.cpu(), scene.dense_rows.cpu(), o.cpu(),
                                   d.cpu())
    assert tuple(counts.tolist()) == want and culled == 0
    return t_k.cpu(), p_k.cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("copies", [(0, 4095), (127, 128), (255, 256), (128, 4095),
                                    (0, 127, 128, 255, 256, 4095), tuple(range(0, 4096, 64))],
                         ids=["first_last", "tile_edge", "second_edge", "far_apart", "all",
                              "across_groups"])
def test_ties_across_tile_edges(cuda, copies):
    """Coincident copies in a 4,096-prim scene, 64 of them spanning three
    groups: the lowest index wins, as in `_sweep`."""
    o, d = down_rays(1000)
    t, prim = _kernel_vs_plain(row_scene(4096, copies), o, d)
    assert bool((prim == min(copies)).all()) and bool((t == 3.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_prims", [1, 31, 32, 33, 300, 4096])
@pytest.mark.parametrize("n_lanes", [1, 1000, 65536])
def test_prim_and_lane_counts(cuda, n_prims, n_lanes):
    """P = 1, 31, 32, 33, not a multiple of the stage, P =
    DENSE_MAX_PRIMS; N = 1, N not a multiple of 256, N = 65,536."""
    o, d = mixed_rays(max(n_lanes, 6), n_prims)
    o, d = o[:, :n_lanes].contiguous(), d[:, :n_lanes].contiguous()
    _kernel_vs_plain(row_scene(n_prims, (0,)), o, d)


@pytest.mark.gpu
def test_zero_lanes_launch_nothing(cuda, monkeypatch):
    scene = device_scene(row_scene(8), "cuda")
    monkeypatch.setattr(dt.DENSE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    e = torch.empty((3, 0), device="cuda")
    t, prim = dt.DENSE_KERNEL(e, e, scene.dense_boxes, scene.dense_rows)
    assert t.shape == prim.shape == (0,) and prim.dtype == torch.int32
    t, prim = dt.trace_planar(scene, e, e)
    assert t.shape == (0,)


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
@pytest.mark.parametrize("n_tris", [1, 33, 300])
def test_kernel_edges_vertices_and_grazing(cuda, n_tris):
    """`test_edges_vertices_and_grazing`'s rays through the kernel."""
    o, d = edge_rays(n_tris)
    _kernel_vs_plain(row_scene(n_tris, (0,), degenerate=2), o, d)


@pytest.mark.gpu
def test_kernel_coplanar_noise_hits(cuda):
    """`test_coplanar_noise_hits_are_guarded`'s rays through the kernel:
    the noise hits come out as `_sweep` reports them."""
    host, _ = tilted_scene()
    o, d = coplanar_rays(4096, 5)
    _, prim = _kernel_vs_plain(host, o, d)
    assert int((prim == 0).sum()) > 10


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
    metrics.clear_spans()
    with metrics.recording():
        t_k, p_k = dt.trace_planar(scene, o, d)
    assert metrics.kernel_launches("dense_trace._sweep", "n") == {128 * 128: 1}
    metrics.clear_spans()
    t_p, p_p = dt._sweep(scene, o, d)
    assert torch.equal(t_k, t_p) and torch.equal(p_k, p_p)
    assert 2000 < int((p_k >= 0).sum()) < 128 * 128


@pytest.mark.gpu
def test_scene_without_its_table_raises_on_cuda(cuda, monkeypatch):
    """A scene above DENSE_MAX_PRIMS carries no grouped table: the dense
    tracer raises on CUDA tensors rather than report misses, and launches
    nothing."""
    from ti_raytrace_tpu_torch import accel

    big = device_scene(row_scene(accel.DENSE_MAX_PRIMS + 1), "cuda")
    o, d = (x.cuda() for x in down_rays(64))
    monkeypatch.setattr(dt.DENSE_KERNEL, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="no grouped table"):
        dt.trace_planar(big, o, d)


@pytest.mark.gpu
def test_cuda_call_counts_a_launch(cuda):
    scene = device_scene(row_scene(140, (3, 130)), "cuda")
    o, d = (x.cuda() for x in down_rays(64))
    metrics.clear_spans()
    with metrics.recording():
        dt.trace_planar(scene, o, d)
        dt.trace_shaded(scene, o, d)
    assert metrics.kernel_launches("dense_trace._sweep", "n") == {64: 2}
    metrics.clear_spans()
    assert dt.DENSE_KERNEL.build_info is not None and dt.DENSE_KERNEL.build_info.path
