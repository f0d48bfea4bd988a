"""Emitter sampling over (..., 3) rows (twin of
ti_raytrace_tpu/scene/sample.py; the render loop's planar form, which
reads the packed light table, is scene/sample_planar.py).

  sample_li     receiver-side next-event estimation;
  sample_light  emitter-side sampling for BDPT light subpaths.

Both pick a light uniformly (`light_prim`), place a point on it (a
triangle folded from the unit square, a sphere's surface, a spot's or a
laser's centre) and read its emission from `mat_color` and its area from
`prim_area`.  Kept from the reference: the sample position interpolates
with barycentrics (a, b) on the edges (v3 - v1), (v2 - v1) and the normal
with the weights swapped (harmless for flat emitters).
"""

from typing import NamedTuple

import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.utils import sampling, vec


class LightSample(NamedTuple):
    pos: torch.Tensor         # (..., 3) point on the emitter
    normal: torch.Tensor      # (..., 3) emitter normal at the point
    direction: torch.Tensor   # (..., 3) from the emitter point (see each sampler)
    emission: torch.Tensor    # (..., 3) radiance (visibility-scaled for NEE)
    dist: torch.Tensor        # (...,) emitter -> receiver distance (sample_li)
    prim: torch.Tensor        # (...,) primitive id of the emitter
    choice_pdf: torch.Tensor  # (...,) light pick * area pdf
    dir_pdf: torch.Tensor     # (...,) direction pdf at the emitter


def _gather_light_prim(scene, u_pick):
    """Uniform light selection -> the emitter's primitive id (int64)."""
    L = scene.n_lights
    idx = torch.clamp((u_pick * L).to(torch.int32), max=L - 1).long()
    return scene.light_prim[idx].long()


def _point_on_prim(scene, prim, a, b):
    """A uniform point and its normal on emitter primitives."""
    pid = torch.clamp(prim, 0, scene.n_prims - 1)
    ptype = scene.prim_type[pid]
    vi = torch.clamp(scene.prim_vidx[pid], 0, max(scene.vtx_pos.shape[0] - 3, 0)).long()

    flip = (a + b) > 1.0  # fold the unit square onto the triangle
    aa = torch.where(flip, 1.0 - a, a)[..., None]
    bb = torch.where(flip, 1.0 - b, b)[..., None]
    v1, v2, v3 = (scene.vtx_pos[vi + k] for k in range(3))
    n1, n2, n3 = (scene.vtx_normal[vi + k] for k in range(3))
    tri_pos = v1 + (v3 - v1) * aa + (v2 - v1) * bb
    tri_n = vec.normalize((1.0 - aa - bb) * n1 + n2 * aa + n3 * bb)

    sid = torch.clamp(scene.prim_vidx[pid], 0, max(scene.shape_type.shape[0] - 1, 0)).long()
    stype = scene.shape_type[sid]
    centre = scene.shape_pos[sid]
    sph_n = sampling.uniform_sample_sphere(a, b)
    sph_pos = centre + sph_n * scene.shape_param[sid, 0:1]
    fixed_n = scene.shape_param[sid, 3:6]  # spot / laser stored normal

    is_tri = (ptype == C.PRIM_TRI)[..., None]
    is_sphere = (stype == C.SHAPE_SPHERE)[..., None]
    pos = torch.where(is_tri, tri_pos, torch.where(is_sphere, sph_pos, centre))
    nrm = torch.where(is_tri, tri_n, torch.where(is_sphere, sph_n, fixed_n))
    return pos, vec.normalize(nrm), ptype, stype, sid


def _emission_and_choice_pdf(scene, prim):
    pid = torch.clamp(prim, 0, scene.n_prims - 1)
    emission = scene.mat_color[scene.prim_mat[pid].long()]
    choice_pdf = 1.0 / (float(scene.n_lights) * torch.clamp(scene.prim_area[pid], min=1e-12))
    return emission, choice_pdf


def sample_li(scene, shade_pos, u3) -> LightSample:
    """Next-event estimation from shade_pos (..., 3) with uniforms u3 (...,
    3): light pick, area a, area b.  `direction` points from the light
    toward the receiver (shadow rays start at the light)."""
    prim = _gather_light_prim(scene, u3[..., 0])
    pos, nrm, ptype, stype, sid = _point_on_prim(scene, prim, u3[..., 1], u3[..., 2])
    emission, choice_pdf = _emission_and_choice_pdf(scene, prim)
    L = float(scene.n_lights)

    d = shade_pos - pos
    dist = torch.clamp(vec.length(d), min=1e-12)
    direction = d / dist[..., None]
    n_dot_l = torch.abs(vec.dot(direction, nrm))
    dir_pdf = sampling.cosine_hemisphere_pdf(n_dot_l)
    vis = torch.ones_like(dist)

    # spot: the falloff cone
    is_spot = (ptype == C.PRIM_SHAPE) & (stype == C.SHAPE_SPOT)
    x1 = scene.shape_param[sid, 0]
    x2 = scene.shape_param[sid, 1]
    x = torch.arccos(torch.clamp(n_dot_l, -1.0, 1.0))
    spot_vis = torch.where(
        x > x2, 0.0,
        torch.where(x > x1, 1.0 - (x - x1) / torch.clamp(x2 - x1, min=1e-12), 1.0))
    vis = torch.where(is_spot, vis * spot_vis, vis)
    dir_pdf = torch.where(is_spot, 1.0, dir_pdf)

    # laser: the beam's visibility cylinder
    is_laser = (ptype == C.PRIM_SHAPE) & (stype == C.SHAPE_LASER)
    proj = vec.dot(direction, nrm) * dist
    r_off = torch.sqrt(torch.clamp(dist * dist - proj * proj, min=0.0))
    vis = torch.where(is_laser & (r_off > scene.shape_param[sid, 0]), 0.0, vis)
    dir_pdf = torch.where(is_laser, 1.0, dir_pdf)
    choice_pdf = torch.where(is_laser, 1.0 / L, choice_pdf)

    return LightSample(pos=pos, normal=nrm, direction=direction,
                       emission=emission * vis[..., None], dist=dist, prim=prim,
                       choice_pdf=choice_pdf, dir_pdf=dir_pdf)


def sample_light(scene, u6) -> LightSample:
    """Emitter-side sampling with uniforms u6 (..., 6): pick, a, b, two
    direction uniforms, and the laser's phase.  `direction` is the
    emitted ray's."""
    prim = _gather_light_prim(scene, u6[..., 0])
    pos, nrm, ptype, stype, sid = _point_on_prim(scene, prim, u6[..., 1], u6[..., 2])
    emission, choice_pdf = _emission_and_choice_pdf(scene, prim)
    L = float(scene.n_lights)

    local, dir_pdf = sampling.cosine_sample_hemisphere_pdf(u6[..., 3], u6[..., 4])
    direction = sampling.to_world(local, nrm)

    # spot: sample the falloff disk
    is_spot = (ptype == C.PRIM_SHAPE) & (stype == C.SHAPE_SPOT)
    x1 = scene.shape_param[sid, 0]
    x2 = scene.shape_param[sid, 1]
    scale = scene.shape_param[sid, 2]
    r_u, phi = sampling.map_to_disk(u6[..., 3], u6[..., 4])
    r1 = scale * torch.tan(x1)
    r2 = scale * torch.tan(x2)
    r = r_u * r2
    spot_fade = torch.where(r > r1, 1.0 - (r - r1) / torch.clamp(r2 - r1, min=1e-12), 1.0)
    spot_pt = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                           torch.sqrt(torch.clamp(scale * scale - r * r, min=0.0))], dim=-1)
    spot_dir = sampling.to_world(spot_pt, nrm)
    emission = torch.where(is_spot[..., None], emission * spot_fade[..., None], emission)
    direction = torch.where(is_spot[..., None], spot_dir, direction)
    dir_pdf = torch.where(is_spot, 1.0, dir_pdf)

    # laser: a parallel beam from a disk around its origin
    is_laser = (ptype == C.PRIM_SHAPE) & (stype == C.SHAPE_LASER)
    radius = scene.shape_param[sid, 0]
    phi_l = u6[..., 5] * C.TWO_PI
    disk_pt = torch.stack([radius * torch.cos(phi_l), radius * torch.sin(phi_l),
                           torch.zeros_like(phi_l)], dim=-1)
    pos = torch.where(is_laser[..., None], pos + sampling.to_world(disk_pt, nrm), pos)
    direction = torch.where(is_laser[..., None], nrm, direction)
    dir_pdf = torch.where(is_laser, 1.0, dir_pdf)
    choice_pdf = torch.where(is_laser, 1.0 / L, choice_pdf)

    return LightSample(pos=pos, normal=nrm, direction=direction, emission=emission,
                       dist=torch.zeros_like(dir_pdf), prim=prim, choice_pdf=choice_pdf,
                       dir_pdf=dir_pdf)
