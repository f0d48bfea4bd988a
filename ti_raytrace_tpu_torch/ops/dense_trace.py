"""Dense planar tracer (twin of ti_raytrace_tpu/ops/dense_trace.py): every
ray against every primitive, in index order.  It is the tracer of scenes
of at most accel.DENSE_MAX_PRIMS primitives (`accel.trace` dispatches on
the primitive count).  On a CUDA tensor the sweep is the hand kernel
csrc/dense_trace.cu (`DENSE_KERNEL`, over the scene's grouped table
`dense_groups`, built once per scene by scene/data.py); on a CPU tensor
it is `_sweep`, plain torch ops in blocks of BLOCK prims, which the
kernel equals bit for bit.

All wavefront tensors are planar: rays are (3, N), attributes
(PRIM_A, N).  The triangle test keeps the reference's operation order as
multiply-adds (no matmul, no library cross product), so CPU and CUDA
tensors give the same bits.

The tie rule is the reference's: within a block the first minimum,
across blocks strict `<`, so among equal t the lowest prim index wins.
It is built explicitly (amin, then the lowest row holding it) because the
index `torch.min(dim)` reports on a tie is not specified.

Differences from the reference, by design: the winner's barycentrics are
recomputed after the sweep from its gathered triangle (the same
multiply-adds on the same operands, so the same bits as inside the
block), and its attribute column is an index gather from `prim_attr`
instead of a one-hot matmul (exact, and no matmul that TF32 could reach
on the card); the plain sweep takes the lanes in chunks of LANE_CHUNK so
the (BLOCK, lanes) temporaries stay bounded whatever the width (each
lane's result depends on that lane alone, so the chunk size changes
nothing); blocks that hold triangles only skip the sphere branch (the
reference skips it for scenes without shapes; here the skip is per
block).
"""

import torch

from ti_raytrace_tpu_torch import accel, metrics
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops.cuda_build import I32, PTR, Launcher
from ti_raytrace_tpu_torch.utils.morton import morton3d

BLOCK = 128
LANE_CHUNK = 65536  # lanes per sweep chunk: a (BLOCK, LANE_CHUNK) f32 temporary is 32 MiB
TABLE_W = 16  # f32 columns of a dense_table row and of a group box
KIND_NONE, KIND_TRI, KIND_SPHERE = 0.0, 1.0, 2.0  # column 9 of a dense_table row
GROUP = 32  # triangle rows per group of `dense_groups`: one warp's width
# A group's box is padded by PAD = max(PAD_EXTENT x its largest extent,
# PAD_SCENE x the scene's largest |coordinate|).
PAD_EXTENT, PAD_SCENE = 1.0 / 16.0, 2.0 ** -12
EPS = 2.0 ** -24  # float32's unit roundoff
# Over the product of its operands' norms, the error of one of the
# Moller-Trumbore triple products as `_triangle_t_uv` computes them (a
# cross product, then a dot, no fused multiply-adds): sqrt(3) gamma_5,
# gamma_5 = 5 EPS / (1 - 5 EPS) < 6 EPS (csrc/dense_trace.cu, "Why the
# cull is exact").
NOISE = 3.0 ** 0.5 * 6.0 * EPS
SAFETY = 1.01  # covers the float32 rounding of the guard's own arithmetic


def scene_has_shapes(scene) -> bool:
    """Does the scene contain analytic-shape primitives?  `SceneBuilder`
    emits one prim per triangle, so shape prims exist iff the prim count
    exceeds the triangle count."""
    return scene.n_prims != scene.n_tris


def _triangle_t_uv(v0, e1, e2, o, d, want_uv: bool = True):
    """Two-sided Moller-Trumbore of broadcastable operands: v0, e1, e2
    and o, d are 3-tuples of component tensors.  Returns (t, u, v) with
    t = INF where the ray misses the triangle (the sign of t unfiltered);
    u and v are None unless want_uv."""
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    s = torch.sign(det)
    adet = torch.abs(det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * s
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * s
    t = (e2x * qx + e2y * qy + e2z * qz) * s
    nondegenerate = adet > 1e-12
    ok = nondegenerate & (u >= 0.0) & (u <= adet) & (v >= 0.0) & (u + v <= adet)
    inv = 1.0 / torch.where(nondegenerate, adet, 1.0)
    t = torch.where(ok, t * inv, C.INF)
    if not want_uv:
        return t, None, None
    return t, torch.where(ok, u * inv, 0.0), torch.where(ok, v * inv, 0.0)


def _columns(a):
    """(B, 3) rows -> three (B, 1) component columns."""
    return a[:, 0:1], a[:, 1:2], a[:, 2:3]


def _block_t_uv(scene, o, d, p0: int, blk: int, with_shapes: bool = True,
                want_uv: bool = True):
    """Hit distances of prims [p0, p0 + blk) x rays, planar (blk, N):
    triangles by `_triangle_t_uv`, PRIM_SHAPE spheres by the nearest root
    of the quadratic.  Returns (t, u, v); t = INF where invalid, its sign
    not yet filtered; u and v are None unless want_uv (the sweep needs
    only t: the winner's barycentrics are recomputed after it)."""
    rays_o = (o[0][None, :], o[1][None, :], o[2][None, :])
    rays_d = (d[0][None, :], d[1][None, :], d[2][None, :])
    sl = slice(p0, p0 + blk)
    t_tri, u, v = _triangle_t_uv(_columns(scene.tri_v0[sl]), _columns(scene.tri_e1[sl]),
                                 _columns(scene.tri_e2[sl]), rays_o, rays_d, want_uv)
    ptype = scene.prim_type[sl][:, None]
    is_tri = ptype == C.PRIM_TRI
    if not with_shapes:
        return torch.where(is_tri, t_tri, C.INF), u, v

    ox, oy, oz = rays_o
    dx, dy, dz = rays_d
    sid = scene.prim_vidx[sl].clamp(0, scene.shape_type.shape[0] - 1).long()
    stype = scene.shape_type[sid][:, None]
    cx, cy, cz = _columns(scene.shape_pos[sid])
    rad = scene.shape_param[sid, 0][:, None]
    ocx = cx - ox
    ocy = cy - oy
    ocz = cz - oz
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    dop = dx * ocx + dy * ocy + dz * ocz
    disc2 = oc2 - dop * dop
    a = dx * dx + dy * dy + dz * dz
    b = -2.0 * dop
    cc = oc2 - rad * rad
    discr = torch.clamp(b * b - 4.0 * a * cc, min=0.0)
    t_sph = (-b - torch.sqrt(discr)) / (2.0 * torch.clamp(a, min=1e-12))
    sph_ok = (ptype == C.PRIM_SHAPE) & (stype == C.SHAPE_SPHERE) & (disc2 < rad * rad)
    return torch.where(is_tri, t_tri, torch.where(sph_ok, t_sph, C.INF)), u, v


def _sweep_chunk(scene, o, d):
    """Closest hit of one lane chunk over all prim blocks -> (t, prim)."""
    n = o.shape[1]
    dev = o.device
    P = scene.n_prims
    best_t = torch.full((n,), C.INF, dtype=torch.float32, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    has_shapes = scene_has_shapes(scene)
    rows = torch.arange(BLOCK, dtype=torch.int32, device=dev)[:, None]
    for p0 in range(0, P, BLOCK):
        blk = min(BLOCK, P - p0)
        t, _, _ = _block_t_uv(scene, o, d, p0, blk, has_shapes and p0 + blk > scene.n_tris,
                              want_uv=False)
        t = torch.where(t > 0.0, t, C.INF)
        tmin = t.amin(dim=0)
        arg = torch.where(t == tmin[None, :], rows[:blk], blk).amin(dim=0)  # first minimum
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_prim = torch.where(closer, p0 + arg, best_prim)
    return best_t, best_prim


def _sweep(scene, o, d, lane_chunk: int = LANE_CHUNK):
    """Block sweep of the whole wavefront, `lane_chunk` lanes at a time."""
    N = o.shape[1]
    if N <= lane_chunk:
        return _sweep_chunk(scene, o, d)
    parts = [_sweep_chunk(scene, o[:, a:a + lane_chunk], d[:, a:a + lane_chunk])
             for a in range(0, N, lane_chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def dense_table(scene):
    """The prim rows of the dense kernel's table (`dense_groups` reorders
    them), (P, TABLE_W) f32 on the scene's device, one row per prim: v0,
    e1, e2 (columns 0:9), the kind (9: KIND_TRI for a PRIM_TRI prim,
    KIND_SPHERE for a PRIM_SHAPE prim whose shape is a sphere, else
    KIND_NONE, a miss), the shape's centre and radius
    gathered as `_block_t_uv` gathers them (10:14; zeros in a scene
    without shapes) and two zero columns.  `SceneBuilder` puts the shape
    prims after the triangles (as `scene_has_shapes` assumes), so each
    lies in a block where `_sweep` takes the sphere branch."""
    P, dev = scene.n_prims, scene.device
    ptype = scene.prim_type
    kind = torch.where(ptype == C.PRIM_TRI, KIND_TRI, KIND_NONE)
    centre = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((P, 1), dtype=torch.float32, device=dev)
    if scene_has_shapes(scene):
        sid = scene.prim_vidx.clamp(0, scene.shape_type.shape[0] - 1).long()
        centre, rad = scene.shape_pos[sid], scene.shape_param[sid, 0:1]
        sphere = (ptype == C.PRIM_SHAPE) & (scene.shape_type[sid] == C.SHAPE_SPHERE)
        kind = torch.where(sphere, KIND_SPHERE, kind)
    return torch.cat([scene.tri_v0, scene.tri_e1, scene.tri_e2, kind[:, None], centre, rad,
                      torch.zeros((P, 2), dtype=torch.float32, device=dev)], dim=1)


def _f32_down(x):
    """float64 -> the largest float32 <= x."""
    y = x.float()
    return torch.where(y.double() > x, torch.nextafter(y, torch.full_like(y, -float("inf"))), y)


def _f32_up(x):
    """float64 -> the smallest float32 >= x."""
    y = x.float()
    return torch.where(y.double() < x, torch.nextafter(y, torch.full_like(y, float("inf"))), y)


def dense_groups(scene):
    """The dense kernel's grouped prim table, built once per scene (by
    scene/data.py::device_scene, whose argument may be any object with
    the fields `dense_table` reads): (boxes (G, TABLE_W), rows (GROUP * G
    + S, TABLE_W)), f32 on the scene's device.

    rows: the triangle rows of `dense_table`, ordered by the morton code
    of their centroids (stable) and cut into G groups of GROUP, the last
    group padded with KIND_NONE rows (they never hit); then the S sphere
    rows, a tail that every warp tests.  Rows of kind KIND_NONE (lasers,
    quads) never hit in `_sweep` and are left out.  Column 14 of every row
    holds its prim index in the scene (-1 on padding); a triangle row's
    columns 10:13, which hold a sphere's centre in a sphere row, hold
    m = (e1 x e2) / (|e1| |e2|), its unit normal scaled by the sine of the
    angle between its edges (zero for a degenerate triangle).

    boxes, one per group: 0:3 and 3:6 the corners of its triangles'
    bounding box padded by PAD and rounded outward to float32, 6:9 a
    centre c, 9 and 10 the grazing guard's k0 and k1, 11 the group's real
    rows, 12 the least |m| among them, 13:16 zero.  A lane with origin o
    and direction d is at risk of a rounding-noise hit on a row whose
    |d . m| < |d| (k0 + k1 |o - c|_1) (csrc/dense_trace.cu, "Why the cull
    is exact")."""
    rows = dense_table(scene)
    dev = rows.device
    ids = torch.arange(rows.shape[0], dtype=torch.float32, device=dev)
    rows = torch.cat([rows[:, :14], ids[:, None], rows[:, 15:]], dim=1)
    tri = rows[rows[:, 9] == KIND_TRI]
    spheres = rows[rows[:, 9] == KIND_SPHERE]
    if tri.shape[0] == 0:
        return torch.zeros((0, TABLE_W), dtype=torch.float32, device=dev), spheres.contiguous()
    v0, e1, e2 = (tri[:, k:k + 3].double() for k in (0, 3, 6))
    cen = v0 + (e1 + e2) / 3.0
    lo, hi = cen.amin(dim=0), cen.amax(dim=0)
    unit = (cen - lo) / torch.clamp(hi - lo, min=1e-30)
    tri = tri[torch.sort(morton3d(unit[:, 0], unit[:, 1], unit[:, 2]), stable=True).indices]
    v0, e1, e2 = (tri[:, k:k + 3].double() for k in (0, 3, 6))
    edges = torch.linalg.vector_norm(e1, dim=1) * torch.linalg.vector_norm(e2, dim=1)
    m = torch.where(edges[:, None] > 0.0,
                    torch.linalg.cross(e1, e2) / torch.clamp(edges, min=1e-300)[:, None], 0.0)
    tri = torch.cat([tri[:, :10], m.float(), tri[:, 13:]], dim=1)

    n = tri.shape[0]
    G = (n + GROUP - 1) // GROUP
    pad = G * GROUP - n
    verts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)  # (n, 3, 3)
    inf = torch.full((pad, 3, 3), float("inf"), dtype=torch.float64, device=dev)
    glo = torch.cat([verts, inf]).view(G, GROUP * 3, 3).amin(dim=1)
    ghi = torch.cat([verts, -inf]).view(G, GROUP * 3, 3).amax(dim=1)
    delta = torch.clamp(torch.maximum(PAD_EXTENT * (ghi - glo).amax(dim=1),
                                      PAD_SCENE * verts.abs().max()), min=2.0 ** -60)
    c = ((glo + ghi) / 2.0).float()
    r = (torch.cat([verts, verts[-1:].expand(pad, 3, 3)]).view(G, GROUP * 3, 3)
         - c.double()[:, None, :]).norm(dim=2).amax(dim=1)
    k0 = _f32_up((NOISE * (1.0 + 8.0 * r / delta) + 5.0 * EPS) * SAFETY)
    k1 = _f32_up(8.0 * NOISE / delta * SAFETY)
    real = torch.clamp(n - GROUP * torch.arange(G, device=dev), max=GROUP).float()
    m_norm = torch.cat([tri[:, 10:13].double().norm(dim=1),
                        torch.full((pad,), float("inf"), dtype=torch.float64, device=dev)])
    m_min = m_norm.view(G, GROUP).amin(dim=1).float()
    boxes = torch.cat([_f32_down(glo - delta[:, None]), _f32_up(ghi + delta[:, None]), c,
                       k0[:, None], k1[:, None], real[:, None], m_min[:, None],
                       torch.zeros((G, 3), dtype=torch.float32, device=dev)], dim=1)
    padding = torch.zeros((pad, TABLE_W), dtype=torch.float32, device=dev)
    padding[:, 14] = -1.0
    return boxes.contiguous(), torch.cat([tri, padding, spheres]).contiguous()


class _DenseSweepKernel(Launcher):
    """csrc/dense_trace.cu: one launch of the grouped sweep."""

    SOURCE = "dense_trace.cu"
    ENTRIES = {"dense_sweep_launch": [PTR, PTR, I32, PTR, I32, PTR, I32, PTR, PTR, PTR, PTR]}
    ERROR = "dense_sweep_error_string"

    def __call__(self, o, d, boxes, rows, counts=None):
        """Closest hit of the planar rays o, d (3, N) over the grouped table
        (`dense_groups`: boxes (G, TABLE_W), rows (GROUP * G + S, TABLE_W)):
        (t (N,) f32, prim (N,) int32), (INF, -1) on a miss.  Every operand
        a contiguous float32 tensor on one CUDA device; N = 0 returns empty
        outputs without a launch.  counts: None, or a (5,) int32 tensor on
        the same device to which the launch adds its (warp, group) pairs
        tested, those whose box no lane of the warp reached (the grazing
        guard then ran), those whose guard ran its loop over the rows, and
        the rows (a group's real rows) of the tested pairs and of the
        looped ones."""
        dev = o.device
        for name, x in (("o", o), ("d", d), ("boxes", boxes), ("rows", rows)):
            if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
                raise ValueError(f"dense_sweep: {name} must be a contiguous torch.float32 "
                                 f"tensor on {dev}, got {x.dtype} on {x.device}, "
                                 f"contiguous={x.is_contiguous()}")
        n = o.shape[1] if o.dim() == 2 else -1
        G = boxes.shape[0] if boxes.dim() == 2 else -1
        if (o.dim() != 2 or o.shape[0] != 3 or d.shape != o.shape or boxes.dim() != 2
                or boxes.shape[1] != TABLE_W or rows.dim() != 2 or rows.shape[1] != TABLE_W
                or rows.shape[0] < GROUP * G or boxes.data_ptr() % 16 or rows.data_ptr() % 16):
            raise ValueError(f"dense_sweep: bad shapes o {tuple(o.shape)} d {tuple(d.shape)} "
                             f"boxes {tuple(boxes.shape)} rows {tuple(rows.shape)} (want (3, N), "
                             f"(3, N), (G, {TABLE_W}), (>= {GROUP} G, {TABLE_W}), 16-byte "
                             f"aligned)")
        if counts is not None and (counts.device != dev or counts.dtype != torch.int32
                                   or counts.shape != (5,)):
            raise ValueError(f"dense_sweep: counts must be a (5,) torch.int32 tensor on {dev}")
        if dev.type != "cuda":
            raise ValueError(f"dense_sweep: the kernel needs CUDA tensors, got {dev}")
        t = torch.empty(n, dtype=torch.float32, device=dev)
        prim = torch.empty(n, dtype=torch.int32, device=dev)
        if n == 0:
            return t, prim
        self.launch("dense_sweep_launch", dev, o.data_ptr(), d.data_ptr(), n, boxes.data_ptr(),
                    G, rows.data_ptr(), rows.shape[0] - GROUP * G, t.data_ptr(), prim.data_ptr(),
                    None if counts is None else counts.data_ptr())
        return t, prim


DENSE_KERNEL = _DenseSweepKernel()


def trace_planar(scene, o, d):
    """Closest hit, planar rays (3, N) -> (t, prim); a miss is (INF, -1).
    The CUDA kernel for CUDA tensors (over the scene's `dense_groups`
    table), `_sweep` for CPU tensors."""
    return _swept(scene, o, d)


def _swept(scene, o, d, active=None, **attrs):
    """`trace_planar` inside the span `dense_trace._sweep`.  Where the span
    records (a profiler open, or `metrics.recording()`), it carries the
    lanes `n`, the table's `groups` and its sphere rows `tail`, besides
    `attrs`; on the card also `counts`, the (5,) int32 device tensor into
    which the launch adds its (warp, group) counts (`DENSE_KERNEL`), and,
    given the mask `active` of a capped sweep's uncapped batch,
    `n_active`, its active lanes as a device scalar; both are left unread
    here so that the call reads nothing back.  Otherwise the span adds no
    torch call and the kernel gets no counts."""
    with metrics.span("dense_trace._sweep") as sp:
        counts = None
        if sp.id is not None:
            groups = scene.dense_boxes.shape[0]
            sp.attrs.update(n=o.shape[1], groups=groups,
                            tail=scene.dense_rows.shape[0] - GROUP * groups, **attrs)
            if o.device.type == "cuda":
                counts = sp.attrs["counts"] = torch.zeros(5, dtype=torch.int32,
                                                          device=o.device)
                if active is not None:
                    sp.attrs["n_active"] = active.sum()
        if o.device.type == "cuda":
            if scene.n_prims > accel.DENSE_MAX_PRIMS and scene.dense_rows.shape[0] == 0:
                raise ValueError(f"dense_trace: a scene of {scene.n_prims} prims, above "
                                 f"accel.DENSE_MAX_PRIMS, carries no grouped table")
            return DENSE_KERNEL(o.contiguous(), d.contiguous(), scene.dense_boxes,
                                scene.dense_rows, counts)
        if o.device.type == "cpu":
            return _sweep(scene, o, d)
        raise NotImplementedError(f"dense_trace: no implementation for {o.device}")


def capacity_lanes(N: int, cap_frac: float) -> int:
    """Lanes a capped sweep of an N-lane wavefront runs on: cap_frac of N
    rounded up to 128, at least 128, at most N.  Callers count capacity
    kills with the same rounding."""
    return min(N, max(128, (int(N * float(cap_frac)) + 127) // 128 * 128))


def trace_planar_capped(scene, o, d, active, cap_frac: float):
    """Closest hit with active-lane packing: the sweep costs N x P for
    every lane, so a mostly parked wavefront (BDPT's fused shadow batch)
    pays for its dead lanes.  Packs the active lanes into a prefix of
    int(N * cap_frac) lanes rounded up to 128 (alive-first stable order,
    the contract of pt_rgb._compact), sweeps the prefix and scatters
    (t, prim) back.  Active lanes beyond the capacity read as misses
    (INF, -1), so a cap needs measured headroom.  Inactive lanes are
    undefined, as `accel.trace` says: those that fit into the prefix
    behind the active ones carry their ray's real hit, the others a miss;
    callers read only the lanes they marked active.  A recording span
    carries `capped=True` and the width before the cap, `n_uncapped`, and
    on the card `n_active` (`_swept`)."""
    N = o.shape[1]
    W = capacity_lanes(N, cap_frac)
    sel = torch.sort((~active).to(torch.int64), stable=True).indices[:W]
    t_c, prim_c = _swept(scene, o.index_select(1, sel), d.index_select(1, sel), active=active,
                         capped=True, n_uncapped=N)
    t = torch.full((N,), C.INF, dtype=torch.float32, device=o.device)
    prim = torch.full((N,), -1, dtype=torch.int32, device=o.device)
    t[sel] = t_c
    prim[sel] = prim_c
    return t, prim


def trace_shaded(scene, o, d):
    """Closest hit + full shading pack.

    Returns (t, prim, uv_bary, attr): t (N,), prim (N,) int32 (-1 on a
    miss), uv_bary (2, N) barycentrics, attr (PRIM_A, N), the winning
    primitive's scene.prim_attr column (zeros on a miss)."""
    t, prim = trace_planar(scene, o, d)
    hit = prim >= 0
    idx = prim.clamp(min=0).long()
    v0, e1, e2 = (x.index_select(0, idx).T for x in (scene.tri_v0, scene.tri_e1,
                                                    scene.tri_e2))
    # shape prims carry zero triangle rows: det = 0, so u = v = 0
    _, u, v = _triangle_t_uv(v0, e1, e2, o, d)
    uv = torch.where(hit[None, :], torch.stack([u, v]), 0.0)
    attr = torch.where(hit[None, :], scene.prim_attr.index_select(1, idx), 0.0)
    return t, prim, uv, attr


def trace_dense(scene, origin_rows, direction_rows):
    """Row-layout wrapper: (N, 3) rays -> (t, prim)."""
    return trace_planar(scene, origin_rows.T.contiguous(), direction_rows.T.contiguous())
