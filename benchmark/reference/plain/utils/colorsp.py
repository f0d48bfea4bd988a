"""Colour-space transforms and tone mapping (twin of
ti_raytrace_tpu/utils/colorsp.py)."""

import torch


def srgb_to_lrgb(srgb):
    """Gamma-decode sRGB -> linear RGB."""
    return torch.where(
        srgb < 0.04045,
        srgb / 12.92,
        torch.pow(torch.clamp(srgb + 0.055, min=0.0) / 1.055, 2.4),
    )


def lrgb_to_srgb(lrgb):
    """Gamma-encode linear RGB -> sRGB, clamped to [0, 1]."""
    out = torch.where(
        lrgb < 0.0031308,
        lrgb * 12.92,
        1.055 * torch.pow(torch.clamp(lrgb, min=1e-12), 1.0 / 2.4) - 0.055,
    )
    return torch.clamp(out, 0.0, 1.0)


def tone_aces(x):
    """Narkowicz ACES filmic curve."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tone_map(hdr, exposure=0.5):
    """exposure -> ACES -> sRGB encode."""
    return lrgb_to_srgb(tone_aces(hdr * exposure))

