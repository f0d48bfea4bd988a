"""Colour-space transforms and tone mapping (twin of
ti_raytrace_tpu/utils/colorsp.py).  `planck` and `calc_matr_rgb_to_xyz`
are host numpy helpers."""

import numpy as np
import torch

from ti_raytrace_tpu_torch.core import constants as C


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


def xyz_to_srgb(xyz):
    """CIE XYZ -> linear sRGB."""
    return xyz @ torch.as_tensor(C.XYZ_TO_SRGB, dtype=xyz.dtype, device=xyz.device).T


def srgb_to_xyz(rgb):
    """Linear sRGB -> CIE XYZ."""
    return rgb @ torch.as_tensor(C.SRGB_TO_XYZ, dtype=rgb.dtype, device=rgb.device).T


def xyz_to_Yxy(xyz):
    """XYZ -> (Y, x, y); zeros where X + Y + Z == 0."""
    s = torch.sum(xyz, dim=-1, keepdim=True)
    safe = torch.where(s > 0.0, 1.0 / torch.where(s > 0.0, s, 1.0), 0.0)
    out = torch.cat([xyz[..., 1:2], xyz[..., 0:1] * safe, xyz[..., 1:2] * safe], dim=-1)
    return torch.where(s > 0.0, out, torch.zeros_like(out))


def Yxy_to_xyz(yxy):
    """(Y, x, y) -> XYZ; zeros where y <= 0."""
    Y, x, y = yxy[..., 0:1], yxy[..., 1:2], yxy[..., 2:3]
    valid = y > 0.0
    k = Y / torch.where(valid, y, 1.0)
    out = torch.cat([k * x, Y, k * (1.0 - x - y)], dim=-1)
    return torch.where(valid, out, torch.zeros_like(out))


def planck(lambda_nm, temperature):
    """Planck's law spectral radiance per nm (host numpy, float64)."""
    lam = np.asarray(lambda_nm, dtype=np.float64) * 1.0e-9
    c1 = 2.0 * C.PLANCK_H * C.LIGHT_C * C.LIGHT_C
    c2 = C.PLANCK_H * C.LIGHT_C / C.BOLTZMANN_K
    return c1 / (np.power(lam, 5.0) * (np.exp(c2 / (lam * temperature)) - 1.0)) * 1.0e-9


def calc_matr_rgb_to_xyz(xy_r, xy_g, xy_b, xyz_white):
    """RGB -> XYZ matrix of three primaries and a white point (Lindbloom's
    method), host numpy, f32."""
    xy = np.array([xy_r, xy_g, xy_b], dtype=np.float64)
    x_rgb, y_rgb = xy[:, 0], xy[:, 1]
    M = np.stack([x_rgb / y_rgb, np.ones(3), (1.0 - x_rgb - y_rgb) / y_rgb])
    S = np.linalg.inv(M) @ np.asarray(xyz_white, dtype=np.float64)
    return (M * S[None, :]).astype(np.float32)
