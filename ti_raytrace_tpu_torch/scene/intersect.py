"""Ray-primitive intersection over (..., 3) rows (twin of
ti_raytrace_tpu/scene/intersect.py): what the BVH oracle
(accel/traverse.py) tests at its leaves.  Traversal computes only the hit
distance per candidate; `hit_attributes` rebuilds the full hit record
once from the winning primitive.  Every gather index is clipped into its
table first, as XLA's gather clamps without a word where torch raises."""

import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.utils import vec


def intersect_tri_soup(origin, direction, v0, e1, e2):
    """Two-sided Moller-Trumbore.  origin/direction and v0/e1/e2 (..., 3).
    Returns (t, u, v) with t = INF on a miss; a hit's t may have any sign
    (callers keep t > 0)."""
    p = vec.cross(direction, e2)
    det = vec.dot(e1, p)
    # two-sided: fold the determinant's sign into T
    tvec = torch.where(det[..., None] > 0.0, origin - v0, v0 - origin)
    adet = torch.abs(det)
    u = vec.dot(tvec, p)
    q = vec.cross(tvec, e1)
    v = vec.dot(direction, q)
    t = vec.dot(e2, q)
    ok = (adet > 1e-12) & (u >= 0.0) & (u <= adet) & (v >= 0.0) & (u + v <= adet)
    inv = 1.0 / torch.where(adet > 1e-12, adet, 1.0)
    return (
        torch.where(ok, t * inv, C.INF),
        torch.where(ok, u * inv, 0.0),
        torch.where(ok, v * inv, 0.0),
    )


def intersect_sphere(origin, direction, centre, radius):
    """Nearest-root ray/sphere hit: t, INF on a miss (a negative t when
    the origin is past the centre, dropped by t > 0 downstream)."""
    oc = centre - origin
    dis_oc_sq = vec.dot(oc, oc)
    dis_op = vec.dot(direction, oc)
    disc = dis_oc_sq - dis_op * dis_op
    inside_cyl = disc < radius * radius
    a = vec.dot(direction, direction)
    b = -2.0 * dis_op
    c = dis_oc_sq - radius * radius
    discr = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    t = (-b - torch.sqrt(discr)) / (2.0 * torch.clamp(a, min=1e-12))
    return torch.where(inside_cyl, t, C.INF)


def _shape_index(scene, pid):
    return torch.clamp(scene.prim_vidx[pid], 0, max(scene.shape_type.shape[0] - 1, 0)).long()


def intersect_prim_any(scene, origin, direction, prim_id):
    """Distance-only intersection with primitive `prim_id` (per lane).
    Shapes other than spheres are never hit."""
    pid = torch.clamp(prim_id, 0, scene.n_prims - 1).long()
    ptype = scene.prim_type[pid]

    t_tri, _, _ = intersect_tri_soup(
        origin, direction, scene.tri_v0[pid], scene.tri_e1[pid], scene.tri_e2[pid])

    sid = _shape_index(scene, pid)
    t_sph = intersect_sphere(origin, direction, scene.shape_pos[sid],
                             scene.shape_param[sid, ..., 0])
    t_shape = torch.where(scene.shape_type[sid] == C.SHAPE_SPHERE, t_sph, C.INF)
    return torch.where(ptype == C.PRIM_TRI, t_tri, t_shape)


def hit_attributes(scene, origin, direction, t, prim_id):
    """The full hit record of the winning primitive: dict(pos, gnormal,
    normal, uv, mat_id, valid).  Sphere normals point from the centre
    (PARITY.md: the reference's own tracer subtracts a scalar there)."""
    valid = (t < C.INF) & (prim_id >= 0)
    pid = torch.clamp(prim_id, 0, scene.n_prims - 1).long()
    is_tri = scene.prim_type[pid] == C.PRIM_TRI

    # --- triangle attributes
    v0 = scene.tri_v0[pid]
    e1 = scene.tri_e1[pid]
    e2 = scene.tri_e2[pid]
    _, u, v = intersect_tri_soup(origin, direction, v0, e1, e2)
    a = 1.0 - u - v
    vi = torch.clamp(scene.prim_vidx[pid], 0, max(scene.vtx_pos.shape[0] - 3, 0)).long()
    n1, n2, n3 = (scene.vtx_normal[vi + k] for k in range(3))
    t1, t2, t3 = (scene.vtx_uv[vi + k] for k in range(3))
    aa, bb, cc = a[..., None], u[..., None], v[..., None]
    tri_pos = v0 + bb * e1 + cc * e2
    tri_gn = vec.cross(e1, e2)
    tri_n = aa * n1 + bb * n2 + cc * n3
    tri_uv = aa * t1 + bb * t2 + cc * t3

    # --- sphere attributes
    centre = scene.shape_pos[_shape_index(scene, pid)]
    sph_pos = origin + t[..., None] * direction
    sph_n = sph_pos - centre

    tri = is_tri[..., None]
    return dict(
        pos=torch.where(tri, tri_pos, sph_pos),
        gnormal=vec.normalize(torch.where(tri, tri_gn, sph_n)),
        normal=vec.normalize(torch.where(tri, tri_n, sph_n)),
        uv=torch.where(tri, tri_uv, torch.zeros_like(tri_uv)),
        mat_id=torch.where(valid, scene.prim_mat[pid], 0),
        valid=valid,
    )
