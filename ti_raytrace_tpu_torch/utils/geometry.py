"""Dielectric Fresnel (twin of ti_raytrace_tpu/utils/geometry.py
`schlick`; the planar ray helpers live in ops/planar.py)."""

import torch


def schlick(cosine, ior):
    """Schlick Fresnel for a dielectric interface."""
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(torch.clamp(1.0 - cosine, min=0.0), 5.0)
