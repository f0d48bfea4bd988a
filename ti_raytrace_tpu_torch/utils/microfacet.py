"""Microfacet / Fresnel toolbox of the Disney BRDF (twin of
ti_raytrace_tpu/utils/microfacet.py, the functions the slice calls)."""

import torch

from ti_raytrace_tpu_torch.core.constants import PI


def sqr(x):
    return x * x


def schlick_fresnel(u):
    """(1-u)^5 with clamp."""
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def gtr2(n_dot_h, a):
    """GTR gamma=2 (GGX) NDF."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / (PI * t * t)


def smith_g_ggx(n_dot_v, alpha_g):
    """Smith masking term, Disney's parameterization."""
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return 1.0 / torch.clamp(
        n_dot_v + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)), min=1e-8
    )
