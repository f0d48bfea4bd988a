"""Planar (structure-of-arrays) wavefront math (twin of
ti_raytrace_tpu/ops/planar.py): 3-vectors are tensors of shape (3, ...)
with the components on axis 0, per-lane scalars are (...,)."""

import torch

from ti_raytrace_tpu_torch.core.constants import TWO_PI


def p3(x, y, z):
    return torch.stack([x, y, z], dim=0)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        dim=0,
    )


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps=1e-20):
    inv = torch.rsqrt(torch.clamp(dot(a, a), min=eps))
    return a * inv[None]


def reflect(i, n):
    return i - (2.0 * dot(i, n))[None] * n


def where(mask, a, b):
    """Select planar vectors by a (...,) lane mask."""
    return torch.where(mask[None], a, b)


def sign_nonzero(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def cosine_sample_hemisphere(u1, u2):
    """Cosine-weighted hemisphere direction, z-up local frame."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return normalize(p3(x, y, z))


def uniform_sample_sphere(u1, u2):
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    phi = TWO_PI * u2
    return p3(r * torch.cos(phi), r * torch.sin(phi), z)


def onb(n):
    """The reference's tangent frame around n."""
    n = normalize(n)
    use_x = torch.abs(n[0]) > torch.abs(n[2])
    zeros = torch.zeros_like(n[0])
    b = where(use_x, p3(-n[1], n[0], zeros), p3(zeros, -n[2], n[1]))
    b = normalize(b)
    t = normalize(cross(b, n))
    return t, b


def to_world(local3, n):
    n_unit = normalize(n)
    t, b = onb(n)
    return t * local3[0][None] + b * local3[1][None] + n_unit * local3[2][None]


def faceforward(n, i, nref):
    return n * sign_nonzero(dot(i, nref))[None]


def offset_ray(p, n):
    """Integer-ulp self-intersection offset along n: the float's bit
    pattern is walked by int(256 * n) ulps, except near the origin where a
    fixed float offset is used."""
    int_scale = 256.0
    float_scale = 1.0 / 2048.0
    origin = 1.0 / 256.0
    i_of = (int_scale * n).to(torch.int32)
    i_p = p.contiguous().view(torch.int32)
    i_p = torch.where(p < 0.0, i_p - i_of, i_p + i_of)
    f_p = i_p.view(torch.float32)
    return torch.where(torch.abs(p) < origin, p + float_scale * n, f_p)


def refract(in_dir, n, eta):
    """Snell refraction; eta is (...,).  Returns (dir, ok)."""
    n_dot_i = dot(n, in_dir)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    ok = k > 0.0
    r = in_dir * eta[None] - n * (eta * n_dot_i + torch.sqrt(torch.clamp(k, min=0.0)))[None]
    return where(ok, r, torch.zeros_like(r)), ok
