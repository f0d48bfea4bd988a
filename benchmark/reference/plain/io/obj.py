"""Wavefront OBJ/MTL loader (host-side numpy; the port's io/obj.py as the
benchmark froze it, with its pure-Python parser only).

Geometry is grouped per material in MTL-declaration order, polygon faces
are fan-triangulated and every triangle corner is a fresh vertex record.
"""

import os
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjMaterial:
    name: str
    diffuse: tuple = (0.8, 0.8, 0.8)
    emissive: tuple = (0.0, 0.0, 0.0)
    shininess: float = 0.0       # Ns
    optical_density: float = 1.0  # Ni
    transparency: float = 1.0    # d (1.0 = opaque)


@dataclass
class ObjMesh:
    """Parsed OBJ: per-material triangle soup."""
    materials: list = field(default_factory=list)          # [ObjMaterial]
    # per material index: (T,3,3) positions, (T,3,3) normals, (T,3,2) uvs
    tri_pos: list = field(default_factory=list)
    tri_normal: list = field(default_factory=list)
    tri_uv: list = field(default_factory=list)

    def triangle_count(self) -> int:
        return sum(int(p.shape[0]) for p in self.tri_pos)


def _parse_mtl(path):
    mats: dict[str, ObjMaterial] = {}
    order: list[str] = []
    cur = None
    if not os.path.exists(path):
        return mats, order
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            k = tok[0]
            if k == "newmtl":
                cur = ObjMaterial(name=tok[1] if len(tok) > 1 else "")
                mats[cur.name] = cur
                order.append(cur.name)
            elif cur is None:
                continue
            elif k == "Kd":
                cur.diffuse = tuple(float(x) for x in tok[1:4])
            elif k == "Ke":
                cur.emissive = tuple(float(x) for x in tok[1:4])
            elif k == "Ns":
                cur.shininess = float(tok[1])
            elif k == "Ni":
                cur.optical_density = float(tok[1])
            elif k == "d":
                cur.transparency = float(tok[1])
            elif k == "Tr":
                cur.transparency = 1.0 - float(tok[1])
    return mats, order


_FACE_RE = re.compile(r"(-?\d+)(?:/(-?\d*)(?:/(-?\d+))?)?")


def _resolve(idx: int, n: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based."""
    return idx - 1 if idx > 0 else n + idx


def load_obj(path: str) -> ObjMesh:
    """Load an OBJ with the Python parser."""
    return _load_obj_py(path)


def _load_obj_py(path: str) -> ObjMesh:
    positions: list = []
    normals: list = []
    uvs: list = []

    mats: dict[str, ObjMaterial] = {}
    mat_order: list[str] = []
    faces_by_mat: dict[str, list] = {}
    cur_mat = None
    base = os.path.dirname(path)

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            k = tok[0]
            if k == "mtllib":
                m, order = _parse_mtl(os.path.join(base, " ".join(tok[1:])))
                for name in order:
                    if name not in mats:
                        mats[name] = m[name]
                        mat_order.append(name)
            elif k == "v":
                positions.append([float(x) for x in tok[1:4]])
            elif k == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif k == "vt":
                uvs.append([float(x) for x in tok[1:3]])
            elif k == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name not in mats:
                    mats[name] = ObjMaterial(name=name)
                    mat_order.append(name)
                cur_mat = name
            elif k == "f":
                if cur_mat is None:
                    cur_mat = "__default__"
                    if cur_mat not in mats:
                        mats[cur_mat] = ObjMaterial(name=cur_mat)
                        mat_order.append(cur_mat)
                corners = []
                for t in tok[1:]:
                    mm = _FACE_RE.match(t)
                    if not mm:
                        continue
                    vi = _resolve(int(mm.group(1)), len(positions))
                    ti = mm.group(2)
                    ti = _resolve(int(ti), len(uvs)) if ti else -1
                    ni = mm.group(3)
                    ni = _resolve(int(ni), len(normals)) if ni else -1
                    corners.append((vi, ti, ni))
                fl = faces_by_mat.setdefault(cur_mat, [])
                for i in range(1, len(corners) - 1):  # fan triangulation
                    fl.append((corners[0], corners[i], corners[i + 1]))

    pos_np = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
    nrm_np = (np.asarray(normals, dtype=np.float32).reshape(-1, 3)
              if normals else np.zeros((0, 3), np.float32))
    uv_np = (np.asarray(uvs, dtype=np.float32).reshape(-1, 2)
             if uvs else np.zeros((0, 2), np.float32))

    mesh = ObjMesh()
    for name in mat_order:
        tris = faces_by_mat.get(name, [])
        mesh.materials.append(mats[name])
        t = len(tris)
        tp = np.zeros((t, 3, 3), np.float32)
        tn = np.zeros((t, 3, 3), np.float32)
        tu = np.zeros((t, 3, 2), np.float32)
        for f_i, tri in enumerate(tris):
            for c_i, (vi, ti, ni) in enumerate(tri):
                tp[f_i, c_i] = pos_np[vi]
                if 0 <= ni < nrm_np.shape[0]:
                    tn[f_i, c_i] = nrm_np[ni]
                if 0 <= ti < uv_np.shape[0]:
                    tu[f_i, c_i] = uv_np[ti]
        mesh.tri_pos.append(tp)
        mesh.tri_normal.append(tn)
        mesh.tri_uv.append(tu)
    return mesh

