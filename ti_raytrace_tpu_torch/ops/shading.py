"""Decode a packed hit record (scene/packs.py) into shading geometry
(twin of ti_raytrace_tpu/ops/shading.py).  Planar: (3, N) / (N,)."""

from typing import NamedTuple

import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import planar as pv


class Hit(NamedTuple):
    valid: torch.Tensor      # (N,) bool
    t: torch.Tensor          # (N,)
    prim: torch.Tensor       # (N,) int32
    pos: torch.Tensor        # (3, N)
    gnormal: torch.Tensor    # (3, N) unit
    normal: torch.Tensor     # (3, N) unit interpolated shading normal
    uv: torch.Tensor         # (2, N) texture coords
    mat_type: torch.Tensor   # (N,) int32
    mat_color: torch.Tensor  # (3, N) authored (sRGB) color / emission
    mat_p0: torch.Tensor     # (N,) metallic | ior
    mat_p1: torch.Tensor     # (N,) roughness | extinction
    area: torch.Tensor       # (N,) primitive area
    mat_tex: torch.Tensor    # (N,) int32 albedo texture id


def decode_hit(o, d, t, prim, uv_bary, attr) -> Hit:
    """Build the hit record from the (PRIM_A, N) attribute columns."""
    valid = (t < C.INF) & (prim >= 0)
    pos = o + d * t[None]

    u, v = uv_bary[0], uv_bary[1]
    a = 1.0 - u - v
    n_tri = attr[3:6] * a[None] + attr[6:9] * u[None] + attr[9:12] * v[None]
    uv_tex = attr[12:14] * a[None] + attr[14:16] * u[None] + attr[16:18] * v[None]

    is_shape = attr[25] > 0.5
    n_sph = pos - attr[26:29]

    return Hit(
        valid=valid,
        t=t,
        prim=prim,
        pos=pos,
        gnormal=pv.normalize(pv.where(is_shape, n_sph, attr[0:3])),
        normal=pv.normalize(pv.where(is_shape, n_sph, n_tri)),
        uv=torch.where(is_shape[None], 0.0, uv_tex),
        mat_type=attr[18].to(torch.int32),
        mat_color=attr[19:22],
        mat_p0=attr[22],
        mat_p1=attr[23],
        area=attr[24],
        mat_tex=attr[31].to(torch.int32),
    )
