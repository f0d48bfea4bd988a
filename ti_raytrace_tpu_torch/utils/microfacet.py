"""Microfacet / Fresnel toolbox of the Disney BRDF (twin of
ti_raytrace_tpu/utils/microfacet.py)."""

import torch

from ti_raytrace_tpu_torch.core.constants import PI


def sqr(x):
    return x * x


def schlick_fresnel(u):
    """(1-u)^5 with clamp."""
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def gtr1(n_dot_h, a):
    """GTR gamma=1 NDF (1/pi at a >= 1)."""
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    general = (a2 - 1.0) / (PI * torch.log(torch.clamp(a2, min=1e-8)) * t)
    return torch.where(a < 1.0, general, 1.0 / PI)


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


def sample_gtr2_half(u1, u2, alpha):
    """Importance-sample the GTR2 half-vector in the local z-up frame:
    (..., 3) of uniforms u1, u2."""
    phi = u1 * 2.0 * PI
    cos_theta = torch.sqrt((1.0 - u2) / (1.0 + (alpha * alpha - 1.0) * u2))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1)
