"""Monte-Carlo sampling helpers over (..., 3) rows (twin of
ti_raytrace_tpu/utils/sampling.py).  Every sampler takes its uniforms as
arguments.  The planar samplers of the render loop live in ops/planar.py."""

import torch

from ti_raytrace_tpu_torch.core.constants import PI
from ti_raytrace_tpu_torch.utils import vec


def map_to_disk(u1, u2):
    """Concentric square -> disk map without data-dependent branches.
    Returns (r, phi)."""
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    use_a = torch.abs(a) > torch.abs(b)
    r = torch.where(use_a, torch.abs(a), torch.abs(b))
    safe_a = torch.where(a == 0.0, 1.0, a)
    safe_b = torch.where(b == 0.0, 1.0, b)
    phi = torch.where(
        use_a,
        (PI / 4.0) * (b / safe_a) + torch.where(a < 0.0, PI, 0.0),
        (PI / 4.0) * (2.0 - a / safe_b) + torch.where(b < 0.0, PI, 0.0),
    )
    return r, torch.where(r == 0.0, 0.0, phi)


def cosine_hemisphere_pdf(cos_theta):
    """cos / pi, floored at 0.01 (the floor bounds the NEE weight of
    grazing light samples)."""
    return torch.clamp(cos_theta / PI, min=0.01)


def cosine_sample_hemisphere(u1, u2):
    """A cosine-distributed direction in the z-up local frame."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return vec.normalize(torch.stack([x, y, z], dim=-1))


def cosine_sample_hemisphere_pdf(u1, u2):
    p = cosine_sample_hemisphere(u1, u2)
    return p, cosine_hemisphere_pdf(p[..., 2])


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    phi = 2.0 * PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def onb(n):
    """(tangent, binormal) of the frame around n (n need not be unit)."""
    n = vec.normalize(n)
    zero = torch.zeros_like(n[..., 0])
    use_x = torch.abs(n[..., 0:1]) > torch.abs(n[..., 2:3])
    b = torch.where(use_x, torch.stack([-n[..., 1], n[..., 0], zero], -1),
                    torch.stack([zero, -n[..., 2], n[..., 1]], -1))
    b = vec.normalize(b)
    t = vec.normalize(vec.cross(b, n))
    return t, b


def to_world(local_dir, n):
    """A z-up local direction in the frame around n."""
    n_unit = vec.normalize(n)
    t, b = onb(n)
    return local_dir[..., 0:1] * t + local_dir[..., 1:2] * b + local_dir[..., 2:3] * n_unit


def power_heuristic(a, b):
    """Veach beta=2 power heuristic: a^2 / (a^2 + b^2), floored at 1e-20."""
    t = a * a
    return t / torch.clamp(b * b + t, min=1e-20)
