"""Host-side scene assembly: triangle soup + analytic shapes -> host dict
(numpy; twin of ti_raytrace_tpu/scene/build.py; smooth normals, the
threaded BVH and the spectral pack rows included).

`SceneBuilder.build_host` returns the same array dict as the reference's,
byte for byte, minus the one key only the reference reads: `cluster_mt`
(its disabled matmul narrow phase).  The BVH (`bvh_*`, accel/lbvh.py) is
built on the CPU from the per-primitive AABBs, as the reference pins its
build to the host.  `scene.data.device_scene` turns either package's dict
into device tensors.
"""

import numpy as np

from ti_raytrace_tpu_torch.accel.lbvh import build_bvh
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.io.image import read_image
from ti_raytrace_tpu_torch.io.obj import load_obj

# Version of the host-array format (same number as the reference's, whose
# layout this builder reproduces): examples/scenes keys its npz cache by it.
BUILD_FORMAT_VERSION = 4


class MaterialRec:
    """Host material record."""

    def __init__(self, mtype=C.MAT_DISNEY, color=(0, 0, 0), p0=0.0, p1=0.0, tex=-1):
        self.type = mtype
        self.color = list(color)
        self.p0 = p0  # metallic | ior
        self.p1 = p1  # roughness | extinction
        self.tex = tex


class ShapeRec:
    """Host analytic-shape record."""

    def __init__(self, stype, pos, param):
        self.type = stype
        self.pos = list(pos)
        self.param = list(param) + [0.0] * (6 - len(param))


def sphere_shape(pos, radius):
    return ShapeRec(C.SHAPE_SPHERE, pos, [radius])


def spot_shape(pos, normal, x1, x2, scale):
    """A spot emitter at pos along normal: full power inside the half-angle
    x1, fading to zero at x2; `scale` is its projection distance."""
    return ShapeRec(C.SHAPE_SPOT, pos, [x1, x2, scale] + list(normal))


def laser_shape(pos, normal, radius):
    """A collimated beam of the given radius from pos along normal."""
    return ShapeRec(C.SHAPE_LASER, pos, [radius, 0.0, 0.0] + list(normal))


class SceneBuilder:
    def __init__(self):
        self.materials: list[MaterialRec] = []
        self.shapes: list[ShapeRec] = []
        self._pos: list[np.ndarray] = []     # (T,3,3) per-corner streams
        self._nrm: list[np.ndarray] = []
        self._uv: list[np.ndarray] = []      # (T,3,2)
        self._tri_mat: list[np.ndarray] = []  # (T,)
        self._shape_prims: list[tuple[int, int]] = []  # (shape, material)
        self.env_img = np.zeros((1, 1, 3), np.float32)
        self.env_power = 0.0
        self.aabb_min = np.full((3,), C.INF, np.float32)
        self.aabb_max = np.full((3,), -C.INF, np.float32)

    def _add_soup(self, pos, nrm, uv, mat_idx):
        self._pos.append(pos)
        self._nrm.append(nrm)
        self._uv.append(uv)
        self._tri_mat.append(np.full((pos.shape[0],), mat_idx, np.int32))
        if pos.shape[0]:
            self.aabb_min = np.minimum(self.aabb_min, pos.reshape(-1, 3).min(0))
            self.aabb_max = np.maximum(self.aabb_max, pos.reshape(-1, 3).max(0))

    def add_obj(self, path: str):
        """Load an OBJ with the reference's material heuristic: emissive
        rgb all > 1 -> light; opaque -> disney; else glass."""
        mesh = load_obj(path)
        for m, tp, tn, tu in zip(mesh.materials, mesh.tri_pos, mesh.tri_normal, mesh.tri_uv):
            em = m.emissive
            if em[0] > 1.0 and em[1] > 1.0 and em[2] > 1.0:
                rec = MaterialRec(C.MAT_LIGHT, color=em)
            elif m.transparency > 0.99:
                rec = MaterialRec(C.MAT_DISNEY, color=m.diffuse, p0=0.0, p1=0.5)
            else:
                rec = MaterialRec(C.MAT_GLASS, color=m.diffuse,
                                  p0=m.optical_density, p1=m.shininess)
            self.materials.append(rec)
            self._add_soup(tp, tn, tu, len(self.materials) - 1)

    def add_triangles(self, pos, nrm, uv, mat: MaterialRec):
        """A procedural triangle soup under one material.
        pos/nrm: (T,3,3); uv: (T,3,2)."""
        self.materials.append(mat)
        self._add_soup(np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
                       np.asarray(uv, np.float32), len(self.materials) - 1)

    def add_shape(self, shape: ShapeRec, mat: MaterialRec):
        self._shape_prims.append((len(self.shapes), len(self.materials)))
        self.shapes.append(shape)
        self.materials.append(mat)

    def add_env(self, path: str, power: float):
        self.env_img = read_image(path)[::-1].copy()  # row 0 at bottom
        self.env_power = float(power)

    def _concat_tris(self):
        if self._pos:
            return (np.concatenate(self._pos, 0), np.concatenate(self._nrm, 0),
                    np.concatenate(self._uv, 0), np.concatenate(self._tri_mat, 0))
        return (np.zeros((0, 3, 3), np.float32), np.zeros((0, 3, 3), np.float32),
                np.zeros((0, 3, 2), np.float32), np.zeros((0,), np.int32))

    def build_host(self, smooth_normals: bool = False, spectral: bool = False) -> dict:
        """Assemble the host-array dict that device_scene consumes.
        spectral: fill the packs' rgb2spec rows (scene/packs.py)."""
        pos, nrm, uv, tri_mat = self._concat_tris()
        T = pos.shape[0]
        P = T + len(self._shape_prims)
        if P == 0:
            raise ValueError("empty scene")

        # face normals where the OBJ had none
        e1 = pos[:, 1] - pos[:, 0]
        e2 = pos[:, 2] - pos[:, 0]
        fn = np.cross(e1, e2)
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        has_n = np.linalg.norm(nrm[:, 0], axis=-1) > 0.0
        nrm = np.where(has_n[:, None, None], nrm, fn[:, None, :])

        if smooth_normals and T:
            nrm = _smooth_normals(pos, nrm)

        # triangle areas (Heron)
        a = np.linalg.norm(pos[:, 0] - pos[:, 1], axis=-1)
        b = np.linalg.norm(pos[:, 0] - pos[:, 2], axis=-1)
        c = np.linalg.norm(pos[:, 2] - pos[:, 1], axis=-1)
        s = 0.5 * (a + b + c)
        tri_area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))

        # primitives: triangles first, then shapes
        prim_type = np.concatenate([np.full((T,), C.PRIM_TRI, np.int32),
                                    np.full((P - T,), C.PRIM_SHAPE, np.int32)])
        prim_vidx = np.concatenate([
            np.arange(T, dtype=np.int32) * 3,
            np.asarray([s_i for s_i, _ in self._shape_prims], np.int32),
        ])
        prim_mat = np.concatenate(
            [tri_mat, np.asarray([m_i for _, m_i in self._shape_prims], np.int32)]
        )

        # shape areas: pi r^2 (the reference's emission-parity quirk)
        shape_area = np.zeros((P - T,), np.float32)
        for k, (s_i, _) in enumerate(self._shape_prims):
            r = self.shapes[s_i].param[0]
            shape_area[k] = np.pi * r * r
        prim_area = np.concatenate([tri_area.astype(np.float32), shape_area])

        mat_type_np = np.asarray([m.type for m in self.materials], np.int32)
        light_prim = np.nonzero(mat_type_np[prim_mat] == C.MAT_LIGHT)[0].astype(np.int32)
        if light_prim.shape[0] == 0:
            light_prim = np.zeros((1,), np.int32)  # keep shapes static; unused

        if self.shapes:
            shape_type = np.asarray([sh.type for sh in self.shapes], np.int32)
            shape_pos = np.asarray([sh.pos for sh in self.shapes], np.float32)
            shape_param = np.asarray([sh.param for sh in self.shapes], np.float32)
        else:
            shape_type = np.zeros((1,), np.int32)
            shape_pos = np.zeros((1, 3), np.float32)
            shape_param = np.zeros((1, 6), np.float32)

        prim_min, prim_max = prim_bounds(dict(
            vtx_pos=pos.reshape(-1, 3), prim_type=prim_type, prim_vidx=prim_vidx,
            shape_type=shape_type, shape_pos=shape_pos, shape_param=shape_param))
        aabb_min = self.aabb_min.copy()
        aabb_max = self.aabb_max.copy()
        if not np.all(aabb_min <= aabb_max):  # shapes-only scene
            aabb_min = prim_min.min(0)
            aabb_max = prim_max.max(0)

        bvh = build_bvh(prim_min, prim_max, aabb_min, aabb_max, device="cpu")

        env = self.env_img
        if self.env_power == 0.0:
            env = np.zeros((1, 1, 3), np.float32)

        zeros3 = np.zeros((P - T, 3), np.float32)
        host = dict(
            mat_type=mat_type_np,
            mat_tex=np.asarray([m.tex for m in self.materials], np.int32),
            mat_color=np.asarray([m.color for m in self.materials], np.float32),
            mat_p0=np.asarray([m.p0 for m in self.materials], np.float32),
            mat_p1=np.asarray([m.p1 for m in self.materials], np.float32),
            prim_type=prim_type,
            prim_vidx=prim_vidx,
            prim_mat=prim_mat,
            prim_area=prim_area,
            tri_v0=np.concatenate([pos[:, 0], zeros3]),
            tri_e1=np.concatenate([e1, zeros3]),
            tri_e2=np.concatenate([e2, zeros3]),
            vtx_pos=pos.reshape(-1, 3) if T else np.zeros((3, 3), np.float32),
            vtx_normal=nrm.reshape(-1, 3) if T else np.zeros((3, 3), np.float32),
            vtx_uv=uv.reshape(-1, 2) if T else np.zeros((3, 2), np.float32),
            shape_type=shape_type,
            shape_pos=shape_pos,
            shape_param=shape_param,
            light_prim=light_prim,
            env_img=env,
            env_power=np.float32(self.env_power),
            bvh_min=bvh["bvh_min"],
            bvh_max=bvh["bvh_max"],
            bvh_prim=bvh["bvh_prim"],
            bvh_escape=bvh["bvh_escape"],
            aabb_min=aabb_min,
            aabb_max=aabb_max,
        )
        from ti_raytrace_tpu_torch.accel.clusters import build_clusters
        from ti_raytrace_tpu_torch.scene.packs import build_light_attr, build_prim_attr

        host["prim_attr"] = build_prim_attr(host, spectral=spectral)
        host["light_attr"] = build_light_attr(host, spectral=spectral)
        host.update(build_clusters(host))
        return host


def prim_bounds(host: dict):
    """Per-primitive AABBs (P, 3) f32 of a host dict, the boxes the BVH is
    built over: a triangle's corners, a sphere's centre +- radius, and any
    other shape as a point at its position (never hit)."""
    ptype = np.asarray(host["prim_type"])
    T = int((ptype == C.PRIM_TRI).sum())  # triangles come first
    corners = np.asarray(host["vtx_pos"])[:3 * T].reshape(T, 3, 3)
    sid = np.asarray(host["prim_vidx"])[T:]
    p0 = np.asarray(host["shape_pos"])[sid]
    radius = np.where(np.asarray(host["shape_type"])[sid] == C.SHAPE_SPHERE,
                      np.asarray(host["shape_param"])[sid, 0], np.float32(0.0))
    prim_min = np.concatenate([corners.min(axis=1), p0 - radius[:, None]]).astype(np.float32)
    prim_max = np.concatenate([corners.max(axis=1), p0 + radius[:, None]]).astype(np.float32)
    return prim_min, prim_max


def _smooth_normals(pos, nrm):
    """Area+angle-weighted normal smoothing across coincident vertices
    (the reference's process_normal; a positional hash joins the corners).

    pos/nrm: (T,3,3).  A neighbour's normal only contributes when it
    agrees with the vertex's own (dot > 0.5)."""
    T = pos.shape[0]
    flat_pos = pos.reshape(-1, 3)
    flat_nrm = nrm.reshape(-1, 3)
    ln = np.linalg.norm(flat_nrm, axis=-1, keepdims=True)
    unit_n = flat_nrm / np.maximum(ln, 1e-20)

    v0, v1, v2 = pos[:, 0], pos[:, 1], pos[:, 2]

    def corner_angle(a, b, c):
        e1 = b - a
        e2 = c - a
        e1 /= np.maximum(np.linalg.norm(e1, axis=-1, keepdims=True), 1e-20)
        e2 /= np.maximum(np.linalg.norm(e2, axis=-1, keepdims=True), 1e-20)
        return np.arccos(np.clip(np.sum(e1 * e2, -1), -1.0, 1.0))

    ang = np.stack(
        [corner_angle(v0, v1, v2), corner_angle(v1, v0, v2), corner_angle(v2, v0, v1)],
        axis=1,
    ).reshape(-1)
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    w = (ang * np.repeat(area, 3))[:, None] * unit_n  # weighted contribution per corner

    key = np.round(flat_pos / 1e-5).astype(np.int64)
    _, _, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)

    # per group of coincident corners (a vertex's valence: tiny), sum the
    # contributions that agree with each member's own normal
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    boundaries = np.nonzero(np.diff(sorted_inv))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [sorted_inv.shape[0]]])

    out = np.zeros_like(flat_nrm)
    for s, e in zip(starts, ends):
        idx = order[s:e]
        nn = unit_n[idx]
        agree = nn @ nn.T > 0.5
        np.fill_diagonal(agree, True)
        out[idx] = agree.astype(np.float32) @ w[idx]
    out /= np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-20)
    return out.reshape(T, 3, 3)
