"""Scene representation: a frozen dataclass of tensors on one device
(twin of ti_raytrace_tpu/scene/data.py).

`device_scene(host, device)` is the weight-transfer function: it takes
the numpy host dict of either package's `SceneBuilder.build_host` (or an
npz cache of one) and moves what the port reads onto `device`; other keys
(the reference's `bvh_*`, `cluster_mt`, and `cluster_attr`, which the
port's tracer replaces by a gather from `prim_attr`) stay on the host.
The env map's 2x2-block bilinear texture and the cluster tracer's
supercluster table are built here once instead of per lookup or trace.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops.cluster_trace import super_table
from ti_raytrace_tpu_torch.texture.texture import pack_blocks


@dataclass(frozen=True)
class SceneData:
    mat_type: torch.Tensor      # (M,) int32 MAT_DISNEY/GLASS/LIGHT
    # --- analytic shapes (S,)
    shape_pos: torch.Tensor     # (S,3) f32
    shape_param: torch.Tensor   # (S,6) f32 (radius | ...)
    # --- environment
    env_img: torch.Tensor       # (Eh,Ew,3) f32 sRGB texels, row 0 at bottom
    env_blocks: torch.Tensor    # (Eh,Ew,12) f32 pack_blocks(env_img)
    env_power: torch.Tensor     # () f32
    # --- packed per-primitive shading table (scene/packs.py)
    prim_attr: torch.Tensor     # (PRIM_A, P) f32
    light_attr: torch.Tensor    # (LIGHT_A, L) f32 per-light sampling pack
    # --- cluster acceleration (accel/clusters.py)
    cluster_bounds: torch.Tensor  # (8, C) f32
    cluster_tri: torch.Tensor     # (12, C*B) f32
    super_bounds: torch.Tensor    # (8, C/32) f32 ops/cluster_trace.super_table
    # --- global
    aabb_min: torch.Tensor      # (3,) f32
    aabb_max: torch.Tensor      # (3,) f32
    # --- host-side static facts
    n_prims: int
    n_lights: int
    sphere_prims: tuple         # ((prim id, shape index), ...) of sphere shapes

    @property
    def device(self) -> torch.device:
        return self.cluster_tri.device


def device_scene(host: dict, device="cpu") -> SceneData:
    """Assemble a SceneData on `device` from a dict of numpy arrays (the
    fields the ported slice reads; later slices add theirs)."""
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
    return SceneData(
        mat_type=arr("mat_type", torch.int32),
        shape_pos=arr("shape_pos"),
        shape_param=arr("shape_param"),
        env_img=torch.as_tensor(env).to(device),
        env_blocks=torch.as_tensor(pack_blocks(env)).to(device),
        env_power=arr("env_power"),
        prim_attr=arr("prim_attr"),
        light_attr=arr("light_attr"),
        cluster_bounds=cluster_bounds,
        cluster_tri=arr("cluster_tri"),
        super_bounds=super_table(cluster_bounds),
        aabb_min=arr("aabb_min"),
        aabb_max=arr("aabb_max"),
        n_prims=P,
        n_lights=int(np.asarray(host["light_prim"]).shape[0]),
        sphere_prims=tuple(spheres),
    )
