"""30-bit morton codes and the Karras delta's count of leading zeros
(twin of ti_raytrace_tpu/utils/morton.py).  Codes are int64 tensors in
[0, 2**30); `clz32` reads its argument as a 32-bit unsigned value."""

import torch


def expand_bits(x):
    """Interleave 10 bits -> 30 bits with 2-bit gaps."""
    x = x.to(torch.int64)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3d(x, y, z):
    """Morton code of normalized [0,1) coordinates (1024^3 quantization,
    x in the lowest bits)."""
    def q(c):
        return torch.clamp(c * 1024.0, 0.0, 1023.0).to(torch.int64)

    return expand_bits(q(x)) | (expand_bits(q(y)) << 1) | (expand_bits(q(z)) << 2)


def clz32(x):
    """Leading zeros of a 32-bit unsigned value, branch-free (torch has
    no clz): 32 minus its bit width."""
    return (32 - _bit_width(x)).to(torch.int32)


def _bit_width(x):
    """Position of the highest set bit (0 for x == 0) by a 5-step binary
    reduction over the low 32 bits of x."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        has = (x >> shift) > 0
        n = n + torch.where(has, shift, 0)
        x = torch.where(has, x >> shift, x)
    return n + (x > 0).to(torch.int64)


def common_upper_bits(a, b):
    """Number of common leading bits of two 32-bit codes: Karras's delta."""
    return clz32(torch.bitwise_xor(a.to(torch.int64), b.to(torch.int64)))
