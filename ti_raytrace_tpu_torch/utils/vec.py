"""Small vector algebra over the last axis (twin of
ti_raytrace_tpu/utils/vec.py).  Every routine broadcasts over leading
batch axes; 3-vectors live in the trailing axis, the (N, 3) row layout
of the BVH oracle (the render loop's planar helpers are ops/planar.py).
Products and sums are separate elementwise ops in a fixed order, so the
oracle rounds alike on the CPU and on CUDA."""

import torch


def dot(a, b):
    """Sum of products over the last axis, in index order, one op at a
    time: the same roundings on every device (a reduction kernel may
    associate differently, and a fused kernel may contract a*b+c)."""
    a, b = torch.broadcast_tensors(a, b)
    out = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k] * b[..., k]
    return out


def dot3(a, b):
    """dot with a kept trailing axis of size 1 (for broadcasting back)."""
    return dot(a, b)[..., None]


def cross(a, b):
    """3-vector cross product, one op at a time (as dot)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a, eps=1e-20):
    return a / torch.sqrt(torch.clamp(dot3(a, a), min=eps))


def reflect(i, n):
    """GLSL-convention reflect: `i` points toward the surface."""
    return i - 2.0 * dot3(i, n) * n


def max_component(v):
    return torch.amax(v, dim=-1)


def min_component(v):
    return torch.amin(v, dim=-1)


def sign_nonzero(x):
    """sign() that maps 0 to +1 (a true 0 would kill the ray offset)."""
    return torch.where(x >= 0.0, 1.0, -1.0)
