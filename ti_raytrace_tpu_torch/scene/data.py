"""Scene representation: a frozen dataclass of tensors on one device
(twin of ti_raytrace_tpu/scene/data.py).

`device_scene(host, device)` is the weight-transfer function: it takes
the numpy host dict of either package's `SceneBuilder.build_host` (or an
npz cache of one) and moves what the port reads onto `device` (the card
unless the caller names another); other keys (the reference's
`cluster_mt`, and `cluster_attr`, which the port's tracer replaces by a
gather from `prim_attr`) stay on the host.  The threaded BVH (`bvh_*`)
and the vertex streams are what the BVH oracle reads
(accel/traverse.py, scene/intersect.py).
The env map's 2x2-block bilinear texture, the cluster tracer's
supercluster table and the dense kernel's grouped prim table are built
here once instead of per lookup or trace (the grouped table only for
scenes of at most accel.DENSE_MAX_PRIMS primitives, the dense tracer's;
larger ones carry it empty).
"""

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ti_raytrace_tpu_torch import accel
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops.cluster_trace import super_table
from ti_raytrace_tpu_torch.ops.dense_trace import TABLE_W, dense_groups
from ti_raytrace_tpu_torch.texture.texture import pack_blocks


@dataclass(frozen=True)
class SceneData:
    mat_type: torch.Tensor      # (M,) int32 MAT_DISNEY/GLASS/LIGHT/SPECTRAL
    mat_color: torch.Tensor     # (M,3) f32 colour / emission (scene/sample.py)
    # --- primitives (P,): what the dense sweep reads (ops/dense_trace.py)
    prim_type: torch.Tensor     # (P,) int32 PRIM_TRI / PRIM_SHAPE
    prim_vidx: torch.Tensor     # (P,) int32 base vertex index | shape index
    prim_mat: torch.Tensor      # (P,) int32 material index
    prim_area: torch.Tensor     # (P,) f32 surface area (scene/sample.py)
    tri_v0: torch.Tensor        # (P,3) f32 (zero rows for shape prims)
    tri_e1: torch.Tensor        # (P,3) f32 v1 - v0
    tri_e2: torch.Tensor        # (P,3) f32 v2 - v0
    # --- vertices, 3 per triangle (V,): scene/intersect.hit_attributes
    vtx_pos: torch.Tensor       # (V,3) f32
    vtx_normal: torch.Tensor    # (V,3) f32
    vtx_uv: torch.Tensor        # (V,2) f32
    # --- analytic shapes (S,)
    shape_type: torch.Tensor    # (S,) int32 SHAPE_SPHERE/QUAD/SPOT/LASER
    shape_pos: torch.Tensor     # (S,3) f32
    shape_param: torch.Tensor   # (S,6) f32 (radius | ...)
    # --- environment
    env_img: torch.Tensor       # (Eh,Ew,3) f32 sRGB texels, row 0 at bottom
    env_blocks: torch.Tensor    # (Eh,Ew,12) f32 pack_blocks(env_img)
    env_power: torch.Tensor     # () f32
    # --- packed per-primitive shading table (scene/packs.py)
    prim_attr: torch.Tensor     # (PRIM_A, P) f32
    light_attr: torch.Tensor    # (LIGHT_A, L) f32 per-light sampling pack
    light_prim: torch.Tensor    # (L,) int32 primitive id of each emitter
    # --- cluster acceleration (accel/clusters.py)
    cluster_bounds: torch.Tensor  # (8, C) f32
    cluster_tri: torch.Tensor     # (12, C*B) f32
    super_bounds: torch.Tensor    # (8, C/32) f32 ops/cluster_trace.super_table
    # --- the dense kernel's grouped prim table (ops/dense_trace.dense_groups)
    dense_boxes: torch.Tensor   # (G, 16) f32 padded box and guard of each group of 32
    dense_rows: torch.Tensor    # (32 G + spheres, 16) f32 rows, morton order, sphere tail
    #                             (both (0, 16) above accel.DENSE_MAX_PRIMS prims)
    # --- threaded BVH, DFS preorder (K = 2P - 1,): accel/lbvh.py, the oracle's
    bvh_min: torch.Tensor       # (K,3) f32
    bvh_max: torch.Tensor       # (K,3) f32
    bvh_prim: torch.Tensor      # (K,) int32 primitive id at a leaf, -1 inside
    bvh_escape: torch.Tensor    # (K,) int32 DFS index after the subtree (K = end)
    # --- global
    aabb_min: torch.Tensor      # (3,) f32
    aabb_max: torch.Tensor      # (3,) f32
    # --- host-side static facts
    n_prims: int
    n_tris: int                 # vertex count // 3 (the reference's triangle count)
    n_lights: int
    sphere_prims: tuple         # ((prim id, shape index), ...) of sphere shapes

    @property
    def device(self) -> torch.device:
        return self.cluster_tri.device

    @property
    def n_nodes(self) -> int:
        return int(self.bvh_prim.shape[0])


def device_scene(host: dict, device="cuda") -> SceneData:
    """Assemble a SceneData on `device` from a dict of numpy arrays (the
    fields the port reads)."""
    def arr(key, dt=torch.float32):
        return torch.as_tensor(np.asarray(host[key]), dtype=dt).to(device).contiguous()

    P = int(np.asarray(host["prim_type"]).shape[0])
    T = int(np.asarray(host["vtx_pos"]).shape[0]) // 3  # the reference's T_est
    vidx = np.asarray(host["prim_vidx"])
    stype = np.asarray(host["shape_type"])
    spheres = []
    for pid in range(min(T, P), P):
        sid = int(np.clip(vidx[pid], 0, stype.shape[0] - 1))
        if stype[sid] == C.SHAPE_SPHERE:  # other shapes never hit (reference tail)
            spheres.append((pid, sid))
    env = np.asarray(host["env_img"], np.float32)
    cluster_bounds = arr("cluster_bounds")
    fields = dict(
        mat_type=arr("mat_type", torch.int32),
        mat_color=arr("mat_color"),
        prim_type=arr("prim_type", torch.int32),
        prim_vidx=arr("prim_vidx", torch.int32),
        prim_mat=arr("prim_mat", torch.int32),
        prim_area=arr("prim_area"),
        tri_v0=arr("tri_v0"),
        tri_e1=arr("tri_e1"),
        tri_e2=arr("tri_e2"),
        vtx_pos=arr("vtx_pos"),
        vtx_normal=arr("vtx_normal"),
        vtx_uv=arr("vtx_uv"),
        shape_type=arr("shape_type", torch.int32),
        shape_pos=arr("shape_pos"),
        shape_param=arr("shape_param"),
        env_img=torch.as_tensor(env).to(device),
        env_blocks=torch.as_tensor(pack_blocks(env)).to(device),
        env_power=arr("env_power"),
        prim_attr=arr("prim_attr"),
        light_attr=arr("light_attr"),
        light_prim=arr("light_prim", torch.int32),
        cluster_bounds=cluster_bounds,
        cluster_tri=arr("cluster_tri"),
        super_bounds=super_table(cluster_bounds),
        bvh_min=arr("bvh_min"),
        bvh_max=arr("bvh_max"),
        bvh_prim=arr("bvh_prim", torch.int32),
        bvh_escape=arr("bvh_escape", torch.int32),
        aabb_min=arr("aabb_min"),
        aabb_max=arr("aabb_max"),
        n_prims=P,
        n_tris=T,
        n_lights=int(np.asarray(host["light_prim"]).shape[0]),
        sphere_prims=tuple(spheres),
    )
    if P <= accel.DENSE_MAX_PRIMS:  # the dense tracer's scenes
        boxes, rows = dense_groups(SimpleNamespace(device=cluster_bounds.device, **fields))
    else:
        boxes = rows = torch.zeros((0, TABLE_W), dtype=torch.float32, device=device)
    return SceneData(dense_boxes=boxes, dense_rows=rows, **fields)
