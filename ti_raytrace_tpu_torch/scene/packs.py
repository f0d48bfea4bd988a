"""Packed per-primitive / per-light attribute tables (host numpy; twin of
ti_raytrace_tpu/scene/packs.py without the spectral rows 32:40, which
stay zero like the reference's non-spectral build).

PRIM_ATTR (PRIM_A, P) columns:
   0: 3 unit geometric normal (zeros for shape prims)
   3:12 corner shading normals n1 | n2 | n3
  12:18 corner uvs uv1 | uv2 | uv3
  18    mat_type          19:22 mat_color (sRGB, as authored)
  22    mat_p0 (metallic | ior)   23 mat_p1 (roughness | extinction)
  24    prim area         25 is_shape
  26:29 shape position    29 shape radius
  30    mat index         31 mat_tex

LIGHT_ATTR (LIGHT_A, L) columns:
   0: 3 v1 | shape position   3: 6 v3 - v1   6: 9 v2 - v1
   9:18 corner normals        18:21 emission   21 area
  22 prim id   23 prim type   24 shape type   25:28 shape normal
  28:31 param0..2
"""

import numpy as np

from ti_raytrace_tpu_torch.core import constants as C

PRIM_A = 40
LIGHT_A = 40


def build_prim_attr(host: dict) -> np.ndarray:
    """(PRIM_A, P) float32 from the host scene dict (see scene/build.py)."""
    P = host["prim_type"].shape[0]
    A = np.zeros((PRIM_A, P), np.float32)

    ptype = host["prim_type"]
    vidx = host["prim_vidx"]
    pmat = host["prim_mat"]
    is_tri = ptype == C.PRIM_TRI

    gn = np.cross(host["tri_e1"], host["tri_e2"])
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    A[0:3, :] = np.where(is_tri[None, :], gn.T, 0.0)

    vtx_n = host["vtx_normal"]
    vtx_uv = host["vtx_uv"]
    tri_ids = np.where(is_tri, vidx, 0)
    for c in range(3):
        A[3 + 3 * c:6 + 3 * c, :] = np.where(
            is_tri[None, :], vtx_n[tri_ids + c].T, 0.0
        )
    uv_cat = np.concatenate(
        [vtx_uv[tri_ids + 0], vtx_uv[tri_ids + 1], vtx_uv[tri_ids + 2]], axis=-1
    )
    A[12:18, :] = np.where(is_tri[None, :], uv_cat.T, 0.0)

    A[18, :] = host["mat_type"][pmat]
    A[19:22, :] = host["mat_color"][pmat].T
    A[22, :] = host["mat_p0"][pmat]
    A[23, :] = host["mat_p1"][pmat]
    A[24, :] = host["prim_area"]
    A[25, :] = (~is_tri).astype(np.float32)

    sidx = np.clip(np.where(~is_tri, vidx, 0), 0, host["shape_pos"].shape[0] - 1)
    A[26:29, :] = np.where(is_tri[None, :], 0.0, host["shape_pos"][sidx].T)
    A[29, :] = np.where(is_tri, 0.0, host["shape_param"][sidx, 0])
    A[30, :] = pmat
    A[31, :] = host["mat_tex"][pmat]
    return A


def build_light_attr(host: dict) -> np.ndarray:
    """(LIGHT_A, L) float32."""
    lp = host["light_prim"]
    B = np.zeros((LIGHT_A, lp.shape[0]), np.float32)

    ptype = host["prim_type"][lp]
    vidx = host["prim_vidx"][lp]
    pmat = host["prim_mat"][lp]
    is_tri = ptype == C.PRIM_TRI

    vtx = host["vtx_pos"]
    vtx_n = host["vtx_normal"]
    tri_ids = np.where(is_tri, vidx, 0)
    v1 = vtx[tri_ids + 0]
    v2 = vtx[tri_ids + 1]
    v3 = vtx[tri_ids + 2]

    sidx = np.clip(np.where(~is_tri, vidx, 0), 0, host["shape_pos"].shape[0] - 1)
    spos = host["shape_pos"][sidx]
    sparam = host["shape_param"][sidx]

    B[0:3, :] = np.where(is_tri[None, :], v1.T, spos.T)
    B[3:6, :] = np.where(is_tri[None, :], (v3 - v1).T, 0.0)
    B[6:9, :] = np.where(is_tri[None, :], (v2 - v1).T, 0.0)
    for c, arr in enumerate((vtx_n[tri_ids + 0], vtx_n[tri_ids + 1], vtx_n[tri_ids + 2])):
        B[9 + 3 * c:12 + 3 * c, :] = np.where(is_tri[None, :], arr.T, 0.0)
    B[18:21, :] = host["mat_color"][pmat].T
    B[21, :] = host["prim_area"][lp]
    B[22, :] = lp
    B[23, :] = ptype
    B[24, :] = np.where(is_tri, 0.0, host["shape_type"][sidx])
    B[25:28, :] = np.where(is_tri[None, :], 0.0, sparam[:, 3:6].T)
    B[28, :] = np.where(is_tri, 0.0, sparam[:, 0])
    B[29, :] = np.where(is_tri, 0.0, sparam[:, 1])
    B[30, :] = np.where(is_tri, 0.0, sparam[:, 2])
    return B
