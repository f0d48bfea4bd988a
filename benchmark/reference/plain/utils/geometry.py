"""Ray/geometry helpers over (..., 3) rows (twin of
ti_raytrace_tpu/utils/geometry.py), cut to dielectric Fresnel and
dispersion.  The planar ray helpers of the render loop live in
ops/planar.py."""

import torch



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

