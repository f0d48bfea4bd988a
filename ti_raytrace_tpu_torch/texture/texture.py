"""Image texture sampling (twin of ti_raytrace_tpu/texture/texture.py).
Textures are (H, W, 3) float32, row 0 at the bottom: `load_texture` reads
one from a PNG, `sample_nearest` and `texture2d` fetch texels and
bilinear footprints, and `texture2d_packed` fetches the same footprint
from a 2x2-block texture (`pack_blocks`) in one gather."""

import numpy as np
import torch

from ti_raytrace_tpu_torch.io.image import read_image


def load_texture(path: str) -> np.ndarray:
    """Host load -> (H, W, 3) float32, row 0 at the bottom."""
    return read_image(path)[::-1].copy()


def sample_nearest(tex: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Texel fetch at integer-truncated texel coordinates, clamped to the
    edge: tex (H, W, 3), x, y in texel units -> (..., 3)."""
    h, w = tex.shape[0], tex.shape[1]
    xi = torch.clamp(x.to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(y.to(torch.int32), 0, h - 1).long()
    return tex[yi, xi]


def texture2d(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear fetch, uv in [0, 1] -> (..., 3): texels floor(u*w) and +1
    with fractional weights, edge clamped (texture2d_packed's footprint)."""
    h, w = tex.shape[0], tex.shape[1]
    x = torch.clamp(u * w, 0.0, w - 1.0)
    y = torch.clamp(v * h, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    c00 = sample_nearest(tex, x0, y0)
    c10 = sample_nearest(tex, x0 + 1.0, y0)
    c01 = sample_nearest(tex, x0, y0 + 1.0)
    c11 = sample_nearest(tex, x0 + 1.0, y0 + 1.0)
    return (c00 * (1 - wx) + c10 * wx) * (1 - wy) + (c01 * (1 - wx) + c11 * wx) * wy


def pack_blocks(tex) -> np.ndarray:
    """Host: (H, W, 3) -> (H, W, 12) with blocks[y, x] = [tex[y,x],
    tex[y,x+1], tex[y+1,x], tex[y+1,x+1]] (edge-clamped), so one gather
    fetches a full bilinear footprint."""
    t = np.asarray(tex)
    xp = np.concatenate([t[:, 1:], t[:, -1:]], axis=1)
    yp = np.concatenate([t[1:], t[-1:]], axis=0)
    xyp = np.concatenate([yp[:, 1:], yp[:, -1:]], axis=1)
    return np.concatenate([t, xp, yp, xyp], axis=2).astype(np.float32)


def texture2d_packed(blocks: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear fetch, uv in [0,1], from a pack_blocks texture -> (N, 3).
    Footprint: texels floor(u*w) and +1 with fractional weights, edge
    clamped."""
    h, w = blocks.shape[0], blocks.shape[1]
    x = torch.clamp(u * w, 0.0, w - 1.0)
    y = torch.clamp(v * h, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    xi = torch.clamp(x0.to(torch.int64), 0, w - 1)
    yi = torch.clamp(y0.to(torch.int64), 0, h - 1)
    c = blocks[yi, xi]  # (..., 12)
    c00, c10, c01, c11 = c[..., 0:3], c[..., 3:6], c[..., 6:9], c[..., 9:12]
    return (c00 * (1 - wx) + c10 * wx) * (1 - wy) + (c01 * (1 - wx) + c11 * wx) * wy
