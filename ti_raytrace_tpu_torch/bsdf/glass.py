"""Smooth dielectric BSDF over (..., 3) rows (twin of
ti_raytrace_tpu/bsdf/glass.py; the render loop's planar form is
bsdf/planar.glass_sample).

One uniform against the Schlick reflectance chooses the lobe; total
internal reflection forces the mirror branch.  `f_or_b` is +1 for
reflection and -1 for transmission.  A delta BSDF: evaluate == pdf == 1.
"""

import torch

from ti_raytrace_tpu_torch.utils import geometry, vec


def sample(u, in_dir, n, ior):
    """u (...,) uniform; in_dir toward the surface; n the shading normal
    (either side); ior per lane or scalar.  Returns (next_dir, f_or_b)."""
    cos_i = vec.dot(in_dir, n)
    exiting = cos_i > 0.0
    n_eff = torch.where(exiting[..., None], -n, n)
    cos_theta_i = torch.abs(cos_i)
    ior = torch.as_tensor(ior, dtype=cos_i.dtype, device=cos_i.device)
    eta = torch.where(exiting, ior, 1.0 / ior)

    refr, ok = geometry.refract(in_dir, n_eff, eta[..., None])
    # total internal reflection: a reflectance above 1 always reflects
    r = torch.where(ok, geometry.schlick(cos_theta_i, ior), u + 1.0)
    refl = vec.reflect(in_dir, n_eff)
    reflect_mask = u < r
    next_dir = torch.where(reflect_mask[..., None], refl, refr)
    return next_dir, torch.where(reflect_mask, 1.0, -1.0)


def evaluate_pdf(n, v, l, ior):
    one = torch.ones(torch.broadcast_shapes(n.shape[:-1], v.shape[:-1]), dtype=n.dtype,
                     device=n.device)
    return one, one


def evaluate(n, v, l, ior):
    return evaluate_pdf(n, v, l, ior)[0]


def pdf(n, v, l, ior):
    return evaluate_pdf(n, v, l, ior)[1]
