"""Planar emitter sampling from the light pack (twin of
ti_raytrace_tpu/scene/sample_planar.py: `_pick_light`, `_point_on_light`,
`sample_li` and the emitter-side `sample_light` of BDPT light subpaths).

The chosen light's column of scene.light_attr (LIGHT_A, L) is fetched by
an exact index gather.  The reference extracts it with a one-hot matmul
at HIGHEST precision because a bf16 pass rounded prim ids and light
positions and killed Veach's NEE on the TPU; a matmul here could run in
TF32 on the card and bring that fault back, so none is used.
"""

import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import planar as pv
from ti_raytrace_tpu_torch.utils.sampling import map_to_disk


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
    choice_pdf, dir_pdf, dir_pdf_std, em_c0, em_c1, em_c2, em_scale,
    vis); direction points from the light toward the receiver; the em_*
    rows are the light's spectral pack (zeros unless the scene was built
    with spectral=True)."""
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
        em_c0=col[32],
        em_c1=col[33],
        em_c2=col[34],
        em_scale=col[35],
        vis=vis,
    )


def sample_light(scene, u6):
    """Emitter-side sample for BDPT light subpaths (the reference's
    Scene.sample_light), planar.  u6: (6, N) uniforms (light pick, point,
    direction, laser disk angle).  Returns dict(pos, normal, direction,
    emission, prim, choice_pdf, dir_pdf, dir_pdf_std, em_c0, em_c1,
    em_c2, em_scale); dir_pdf is the reference's density floored at 0.01,
    dir_pdf_std the unfloored one (the corrected estimator's); the em_*
    rows are the light's spectral pack, as in `sample_li`."""
    col, _ = _pick_light(scene, u6[0])
    pos, nrm, is_tri = _point_on_light(col, u6[1], u6[2])

    emission = col[18:21]
    area = col[21]
    prim = col[22].to(torch.int32)
    L = float(scene.n_lights)
    choice_pdf = 1.0 / (L * torch.clamp(area, min=1e-12))

    local = pv.cosine_sample_hemisphere(u6[3], u6[4])
    dir_pdf_std = local[2] / C.PI
    dir_pdf = torch.clamp(dir_pdf_std, min=0.01)
    direction = pv.to_world(local, nrm)

    stype = col[24]
    is_shape = ~is_tri
    is_spot = is_shape & (stype == C.SHAPE_SPOT)
    x1, x2, scale = col[28], col[29], col[30]
    r_u, phi = map_to_disk(u6[3], u6[4])
    r1 = scale * torch.tan(x1)
    r2 = scale * torch.tan(x2)
    r = r_u * r2
    spot_fade = torch.where(r > r1, 1.0 - (r - r1) / torch.clamp(r2 - r1, min=1e-12), 1.0)
    spot_pt = pv.p3(r * torch.cos(phi), r * torch.sin(phi),
                    torch.sqrt(torch.clamp(scale * scale - r * r, min=0.0)))
    spot_dir = pv.to_world(spot_pt, nrm)
    emission = pv.where(is_spot, emission * spot_fade[None], emission)
    direction = pv.where(is_spot, spot_dir, direction)
    dir_pdf = torch.where(is_spot, 1.0, dir_pdf)
    dir_pdf_std = torch.where(is_spot, 1.0, dir_pdf_std)

    is_laser = is_shape & (stype == C.SHAPE_LASER)
    radius = col[28]
    phi_l = u6[5] * C.TWO_PI
    disk_off = pv.to_world(pv.p3(radius * torch.cos(phi_l), radius * torch.sin(phi_l),
                                 torch.zeros_like(phi_l)), nrm)
    pos = pv.where(is_laser, pos + disk_off, pos)
    direction = pv.where(is_laser, nrm, direction)
    dir_pdf = torch.where(is_laser, 1.0, dir_pdf)
    dir_pdf_std = torch.where(is_laser, 1.0, dir_pdf_std)
    choice_pdf = torch.where(is_laser, 1.0 / L, choice_pdf)

    return dict(
        pos=pos,
        normal=nrm,
        direction=direction,
        emission=emission,
        prim=prim,
        choice_pdf=choice_pdf,
        dir_pdf=dir_pdf,
        dir_pdf_std=dir_pdf_std,
        em_c0=col[32],
        em_c1=col[33],
        em_c2=col[34],
        em_scale=col[35],
    )
