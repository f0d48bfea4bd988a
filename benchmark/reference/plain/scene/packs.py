"""Packed per-primitive / per-light attribute tables (host numpy; twin of
ti_raytrace_tpu/scene/packs.py).  The spectral rows are filled when
`build_host` runs with spectral=True and stay zero otherwise: the rgb2spec
fetches are per material and happen here, on the host, so the render loop
never touches the 64^3 table.

PRIM_ATTR (PRIM_A, P) columns:
   0: 3 unit geometric normal (zeros for shape prims)
   3:12 corner shading normals n1 | n2 | n3
  12:18 corner uvs uv1 | uv2 | uv3
  18    mat_type          19:22 mat_color (sRGB, as authored)
  22    mat_p0 (metallic | ior)   23 mat_p1 (roughness | extinction)
  24    prim area         25 is_shape
  26:29 shape position    29 shape radius
  30    mat index         31 mat_tex
  32:35 rgb2spec sigmoid coefficients of srgb_to_lrgb(mat_color)
  35:38 rgb2spec coefficients of the emission tint (emission / |emission|)
  38    emission scale |emission|
  39    measured-SPD selector: mat_tex for MAT_SPECTRAL, else -1

LIGHT_ATTR (LIGHT_A, L) columns:
   0: 3 v1 | shape position   3: 6 v3 - v1   6: 9 v2 - v1
   9:18 corner normals        18:21 emission   21 area
  22 prim id   23 prim type   24 shape type   25:28 shape normal
  28:31 param0..2
  32:35 rgb2spec coefficients of the emission tint   35 emission scale
"""

import numpy as np

from reference.plain.core import constants as C

PRIM_A = 40
LIGHT_A = 40


def build_prim_attr(host: dict, spectral: bool = False) -> np.ndarray:
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
    if spectral:
        refl_c, em_c, em_s = _material_spectral_rows(host)
        A[32:35, :] = refl_c[pmat].T
        A[35:38, :] = em_c[pmat].T
        A[38, :] = em_s[pmat]
        A[39, :] = np.where(
            host["mat_type"][pmat] == C.MAT_SPECTRAL,
            host["mat_tex"][pmat].astype(np.float32),
            -1.0,
        )
    return A


def _material_spectral_rows(host):
    """Per-material rgb2spec coefficients: (reflectance coefficients of
    the decoded colour, emission-tint coefficients, emission scale).  The
    emission tint is fetched without the sRGB decode, so the effective
    emission luminance (|emission| * tint) matches the RGB pipeline."""
    from reference.plain.spectral.rgb2spec import load_table

    table = load_table()
    color = host["mat_color"].astype(np.float64)

    def s2l(c):
        c = np.clip(c, 0.0, None)
        return np.where(c < 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)

    refl_c = table.fetch(s2l(np.clip(color, 0.0, 1.0)))
    scale = np.linalg.norm(color, axis=-1)
    tint = np.where(scale[:, None] > 0.0, color / np.maximum(scale[:, None], 1e-20), 0.0)
    em_c = table.fetch(tint)
    return refl_c.astype(np.float32), em_c.astype(np.float32), scale.astype(np.float32)


def build_light_attr(host: dict, spectral: bool = False) -> np.ndarray:
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
    if spectral:
        _, em_c, em_s = _material_spectral_rows(host)
        B[32:35, :] = em_c[pmat].T
        B[35, :] = em_s[pmat]
    return B
