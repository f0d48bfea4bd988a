"""30-bit morton codes (twin of ti_raytrace_tpu/utils/morton.py:
`expand_bits`, `morton3d`).  Codes are int64 tensors in [0, 2**30)."""

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
