"""Debug AOV integrator: a single-bounce viewer (twin of
ti_raytrace_tpu/integrators/debug.py).  The default AOV is the flat
material colour; the normals, depth and a primitive-id false colour are
selectable."""

import torch

from ti_raytrace_tpu_torch.accel import trace_shaded
from ti_raytrace_tpu_torch.camera import CameraSpec, ray_directions, ray_origins
from ti_raytrace_tpu_torch.ops import planar as pv
from ti_raytrace_tpu_torch.ops.shading import decode_hit

AOVS = ("albedo", "normal", "gnormal", "fnormal", "depth", "prim")


def render_frame(scene, spec: CameraSpec, cam, frame: int, key, aov: str = "albedo"):
    """One AOV frame: (W, H, 3), zeros where the camera ray misses (a
    viewer overwrites its film with it, nothing accumulates)."""
    o = ray_origins(spec, cam).T.contiguous()
    d = ray_directions(spec, cam, frame, key).T.contiguous()
    t, prim, uv_bary, attr = trace_shaded(scene, o, d)
    hit = decode_hit(o, d, t, prim, uv_bary, attr)

    if aov == "albedo":
        img = hit.mat_color
    elif aov == "normal":
        img = (hit.normal + 1.0) * 0.5
    elif aov == "gnormal":
        img = (hit.gnormal + 1.0) * 0.5
    elif aov == "fnormal":
        img = (pv.faceforward(hit.normal, -d, hit.gnormal) + 1.0) * 0.5
    elif aov == "depth":
        norm = t / torch.clamp(torch.where(hit.valid, t, 0.0).max(), min=1e-6)
        img = norm[None, :].expand(3, -1)
    elif aov == "prim":
        img = torch.stack([(prim % 7).to(torch.float32) / 7.0,
                           (prim % 13).to(torch.float32) / 13.0,
                           (prim % 17).to(torch.float32) / 17.0])
    else:
        raise ValueError(f"unknown aov {aov!r}")

    img = torch.where(hit.valid[None, :], img, 0.0)
    return img.T.reshape(spec.width, spec.height, 3)
