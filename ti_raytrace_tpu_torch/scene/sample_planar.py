"""Planar emitter sampling from the light pack (twin of
ti_raytrace_tpu/scene/sample_planar.py: `_pick_light`, `_point_on_light`,
`sample_li`).

The chosen light's column of scene.light_attr (LIGHT_A, L) is fetched by
an exact index gather.  The reference extracts it with a one-hot matmul
at HIGHEST precision because a bf16 pass rounded prim ids and light
positions and killed Veach's NEE on the TPU; a matmul here could run in
TF32 on the card and bring that fault back, so none is used.
Emitter-side sampling (`sample_light`) belongs to the BDPT slice (ROADMAP
'to port').
"""

import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import planar as pv


def _pick_light(scene, u_pick):
    """(N,) uniform -> (LIGHT_A, N) light column + (N,) int64 index."""
    L = scene.n_lights
    idx = torch.clamp((u_pick * L).to(torch.int32), max=L - 1).long()
    return scene.light_attr.index_select(1, idx), idx


def _point_on_light(col, a, b):
    """Uniform point + normal from a light column (the reference's
    Scene.get_prim_random_point_normal, with its swapped normal-weight
    quirk).  Returns (pos, unit normal, is_tri)."""
    is_tri = col[23] == C.PRIM_TRI
    is_sphere = ~is_tri & (col[24] == C.SHAPE_SPHERE)

    flip = (a + b) > 1.0
    ta = torch.where(flip, 1.0 - a, a)
    tb = torch.where(flip, 1.0 - b, b)
    v1 = col[0:3]
    e31 = col[3:6]
    e21 = col[6:9]
    tri_pos = v1 + e31 * ta[None] + e21 * tb[None]
    tri_n = pv.normalize(
        col[9:12] * (1.0 - ta - tb)[None] + col[12:15] * ta[None] + col[15:18] * tb[None]
    )

    sph_n = pv.uniform_sample_sphere(a, b)
    sph_pos = col[0:3] + sph_n * col[28][None]

    pos = pv.where(is_tri, tri_pos, pv.where(is_sphere, sph_pos, col[0:3]))
    nrm = pv.where(is_tri, tri_n, pv.where(is_sphere, sph_n, col[25:28]))
    return pos, pv.normalize(nrm), is_tri


def sample_li(scene, shade_pos, u3):
    """Receiver-side NEE sample (the reference's Scene.sample_li), planar.

    shade_pos: (3, N); u3: (3, N) uniforms (light pick, then the point on
    it).  Returns dict(pos, normal, direction, emission, dist, prim,
    choice_pdf, dir_pdf, dir_pdf_std, vis); direction points from the
    light toward the receiver."""
    col, _ = _pick_light(scene, u3[0])
    pos, nrm, is_tri = _point_on_light(col, u3[1], u3[2])

    emission = col[18:21]
    area = col[21]
    prim = col[22].to(torch.int32)
    L = float(scene.n_lights)
    choice_pdf = 1.0 / (L * torch.clamp(area, min=1e-12))

    d = shade_pos - pos
    dist = torch.clamp(pv.length(d), min=1e-12)
    direction = d * (1.0 / dist)[None]
    n_dot_l = torch.abs(pv.dot(direction, nrm))
    dir_pdf_std = n_dot_l / C.PI  # unfloored (the corrected BDPT estimator)
    dir_pdf = torch.clamp(dir_pdf_std, min=0.01)
    vis = torch.ones_like(dist)

    stype = col[24]
    is_shape = ~is_tri
    is_spot = is_shape & (stype == C.SHAPE_SPOT)
    x1, x2 = col[28], col[29]
    x = torch.arccos(torch.clamp(n_dot_l, -1.0, 1.0))
    spot_vis = torch.where(
        x > x2, 0.0,
        torch.where(x > x1, 1.0 - (x - x1) / torch.clamp(x2 - x1, min=1e-12), 1.0))
    vis = torch.where(is_spot, vis * spot_vis, vis)
    dir_pdf = torch.where(is_spot, 1.0, dir_pdf)
    dir_pdf_std = torch.where(is_spot, 1.0, dir_pdf_std)

    is_laser = is_shape & (stype == C.SHAPE_LASER)
    proj = pv.dot(direction, nrm) * dist
    r_off = torch.sqrt(torch.clamp(dist * dist - proj * proj, min=0.0))
    vis = torch.where(is_laser & (r_off > col[28]), 0.0, vis)
    dir_pdf = torch.where(is_laser, 1.0, dir_pdf)
    dir_pdf_std = torch.where(is_laser, 1.0, dir_pdf_std)
    choice_pdf = torch.where(is_laser, 1.0 / L, choice_pdf)

    return dict(
        pos=pos,
        normal=nrm,
        direction=direction,
        emission=emission * vis[None],
        dist=dist,
        prim=prim,
        choice_pdf=choice_pdf,
        dir_pdf=dir_pdf,
        dir_pdf_std=dir_pdf_std,
        vis=vis,
    )
