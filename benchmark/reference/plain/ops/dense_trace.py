"""Dense planar tracer in plain PyTorch: the port's ops/dense_trace.py as
the benchmark froze it, with its kernel left out.  `trace_planar` runs
the plain sweep `_sweep` on every device (no kernel, no grouped table, no
span); the port's kernel gives the same bits on the card.

Every ray against every primitive, in index order, in blocks of BLOCK
prims and chunks of LANE_CHUNK lanes.  The triangle test keeps the
reference's operation order as multiply-adds (no matmul, no library cross
product).  The tie rule is the reference's: within a block the first
minimum, across blocks strict `<`, so among equal t the lowest prim index
wins, built explicitly (amin, then the lowest row holding it).  The
winner's barycentrics are recomputed after the sweep from its gathered
triangle, and its attribute column is an index gather from `prim_attr`.
"""

import torch

from reference.plain.core import constants as C

BLOCK = 128
LANE_CHUNK = 65536  # lanes per sweep chunk: a (BLOCK, LANE_CHUNK) f32 temporary is 32 MiB


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

def trace_planar(scene, o, d):
    """Closest hit, planar rays (3, N) -> (t, prim); a miss is (INF, -1)."""
    return _sweep(scene, o, d)


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
    callers read only the lanes they marked active."""
    N = o.shape[1]
    W = capacity_lanes(N, cap_frac)
    sel = torch.sort((~active).to(torch.int64), stable=True).indices[:W]
    t_c, prim_c = trace_planar(scene, o.index_select(1, sel), d.index_select(1, sel))
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
