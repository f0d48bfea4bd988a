"""Image texture sampling (twin of ti_raytrace_tpu/texture/texture.py).
Textures are (H, W, 3) float32, row 0 at the bottom; `texture2d_packed`
fetches a bilinear footprint from a 2x2-block texture (`pack_blocks`) in
one gather."""

import numpy as np
import torch


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

