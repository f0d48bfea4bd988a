"""Ray/geometry helpers over (..., 3) rows (twin of
ti_raytrace_tpu/utils/geometry.py): the branch-free AABB slab test of the
BVH oracle, the integer-ulp ray offset, refraction, face-forwarding,
dielectric Fresnel and dispersion.  The planar ray helpers of the render
loop live in ops/planar.py."""

import torch

from ti_raytrace_tpu_torch.core.constants import INF
from ti_raytrace_tpu_torch.utils import vec


def slabs(origin, direction, box_min, box_max, t_max=INF):
    """Ray-AABB slab test, branch-free: a hit overlaps [0, t_max].  Also
    returns the entry distance.  Shapes broadcast over (..., 3)."""
    tiny = torch.where(direction >= 0, 1e-12, -1e-12)
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-12, tiny, direction)
    t1 = (box_min - origin) * inv_d
    t2 = (box_max - origin) * inv_d
    t_near = torch.amax(torch.minimum(t1, t2), dim=-1)
    t_far = torch.amin(torch.maximum(t1, t2), dim=-1)
    t_entry = torch.clamp(t_near, min=0.0)
    hit = (t_entry <= t_far) & (t_near <= t_max)
    return hit, t_entry


def offset_ray(p, n):
    """Self-intersection-safe ray origin: an integer-ulp walk of p along
    the normal n (Ray Tracing Gems ch. 6), a plain float step near 0."""
    int_scale = 256.0
    float_scale = 1.0 / 2048.0
    origin = 1.0 / 256.0

    p = torch.as_tensor(p, dtype=torch.float32)
    i_of = (int_scale * n).to(torch.int32)
    i_p = p.view(torch.int32)
    i_p = torch.where(p < 0.0, i_p - i_of, i_p + i_of)
    f_p = i_p.view(torch.float32)
    return torch.where(torch.abs(p) < origin, p + float_scale * n, f_p)


def refract(in_dir, n, eta):
    """Snell refraction: in_dir points toward the surface, n opposes it.
    Returns (refracted direction, success mask)."""
    n_dot_i = vec.dot3(n, in_dir)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    ok = k[..., 0] > 0.0
    r = eta * in_dir - (eta * n_dot_i + torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(ok[..., None], r, torch.zeros_like(r)), ok


def faceforward(n, i, nref):
    """Flip the shading normal n to the hemisphere of i with respect to
    the geometric normal nref."""
    return vec.sign_nonzero(vec.dot3(i, nref)) * n


def schlick(cosine, ior):
    """Schlick Fresnel for a dielectric interface."""
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(torch.clamp(1.0 - cosine, min=0.0), 5.0)


def bk7_ior(lambda_nm):
    """BK7 Sellmeier dispersion curve; lambda in nanometres."""
    lam = lambda_nm / 1000.0
    l2 = lam * lam
    return torch.sqrt(
        1.0
        + 1.03961212 * l2 / (l2 - 0.00600069867)
        + 0.231792344 * l2 / (l2 - 0.0200179144)
        + 1.01046945 * l2 / (l2 - 103.560653)
    )
