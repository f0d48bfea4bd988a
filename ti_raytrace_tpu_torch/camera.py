"""Pinhole camera: host orbit rig + device wavefront ray generation (twin
of ti_raytrace_tpu/camera.py).

Intrinsics follow the reference's full-frame model: fx = focal * width /
2.4, principal point at the image centre.  Film arrays are (W, H, ...)
indexed [x, y] with y up; raster lane n is pixel (x = n // H, y = n % H).
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ti_raytrace_tpu_torch.core import rng

FULL_HGT = 2.4  # full-frame sensor height


@dataclass(frozen=True)
class CameraSpec:
    width: int
    height: int
    focal: float = 2.0

    @property
    def fx(self) -> float:
        return self.focal * self.width / FULL_HGT

    @property
    def fy(self) -> float:
        return self.fx

    @property
    def cx(self) -> float:
        return self.width * 0.5

    @property
    def cy(self) -> float:
        return self.height * 0.5


class CameraState(NamedTuple):
    view: torch.Tensor      # (4,4) f32 world -> camera
    view_inv: torch.Tensor  # (4,4) f32 camera -> world
    eye: torch.Tensor       # (3,) f32


def orbit_camera(target, yaw: float, pitch: float, scale: float,
                 device="cuda") -> CameraState:
    """Orbit-rig view matrix, computed in float64 numpy and stored f32:
    eye = target + scale * (cos p sin y, sin p, cos p cos y), with the up
    vector following the pitch."""
    target = np.asarray(target, np.float64)
    pitch = float(np.clip(pitch, -1.57, 1.57))
    eye = target + scale * np.array(
        [np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw)]
    )
    up = np.array(
        [-np.sin(pitch) * np.sin(yaw), np.cos(pitch), -np.sin(pitch) * np.cos(yaw)]
    )
    zaxis = eye - target
    zaxis /= np.linalg.norm(zaxis)
    xaxis = np.cross(up, zaxis)
    xaxis /= np.linalg.norm(xaxis)
    yaxis = np.cross(zaxis, xaxis)
    view = np.eye(4)
    view[0, :3], view[0, 3] = xaxis, -np.dot(xaxis, eye)
    view[1, :3], view[1, 3] = yaxis, -np.dot(yaxis, eye)
    view[2, :3], view[2, 3] = zaxis, -np.dot(zaxis, eye)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CameraState(view=f32(view), view_inv=f32(np.linalg.inv(view)), eye=f32(eye))


def ray_origins(spec: CameraSpec, cam: CameraState) -> torch.Tensor:
    """(W*H, 3) origins (every lane at the eye)."""
    return cam.eye.expand(spec.width * spec.height, 3)


def ray_directions(spec: CameraSpec, cam: CameraState, frame: int, key) -> torch.Tensor:
    """(W*H, 3) unit primary directions in raster lane order (lane n is
    pixel x = n // H, y = n % H), with the +-0.5 px jitter (off on frame
    0).  The uniforms are the reference's (2, W, H) draw, row-major; the
    length is divided out as the reference's norm does."""
    W, H = spec.width, spec.height
    dev = cam.eye.device
    px = torch.arange(W, dtype=torch.float32, device=dev).repeat_interleave(H)
    py = torch.arange(H, dtype=torch.float32, device=dev).repeat(W)
    dw = _camera_dirs(spec, cam, frame, key, px, py)
    norm = torch.sqrt(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2])
    return (dw / norm[None, :]).T


def project(spec: CameraSpec, cam: CameraState, p):
    """World points (..., 3) -> (pixel_x, pixel_y, wi, valid): the
    light-tracing splat projection.  The view transform is written as
    multiply-adds in the reference's product order (no matmul: one ulp
    moves a splat pixel), and pixels truncate toward zero as the
    reference's int32 cast does (a float in (-1, 0) lands on pixel 0).
    Coordinates are clamped to [-2, size + 1] and NaN mapped to 0 before
    the cast, which then agrees on every device (an out-of-range cast is
    undefined on the CPU)."""
    V = cam.view
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    vx = px * V[0, 0] + py * V[0, 1] + pz * V[0, 2] + V[0, 3]
    vy = px * V[1, 0] + py * V[1, 1] + pz * V[1, 2] + V[1, 3]
    z = px * V[2, 0] + py * V[2, 1] + pz * V[2, 2] + V[2, 3]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, -1e-12)

    def pixel(f, size):
        f = torch.nan_to_num(f, nan=0.0).clamp(-2.0, size + 1.0)
        return f.to(torch.int32)

    u = pixel(-vx / safe_z * spec.fx + spec.cx, spec.width)
    v = pixel(-vy / safe_z * spec.fy + spec.cy, spec.height)
    valid = (u >= 0) & (u < spec.width) & (v >= 0) & (v < spec.height) & (z <= 0.0)
    wi = p - cam.eye
    wi = wi / torch.clamp(torch.linalg.vector_norm(wi, dim=-1, keepdim=True), min=1e-20)
    return u, v, wi, valid


@lru_cache(maxsize=None)
def morton_pixel_order(width: int, height: int):
    """Static Z-order pixel permutation for a (width, height) film: host
    int32 arrays (perm, inv) with lane n covering raster pixel perm[n]
    (raster id = x * height + y) and inv[raster] = lane.  The cached arrays
    are shared: callers must not write to them."""
    xs = np.arange(width, dtype=np.uint32)[:, None]
    ys = np.arange(height, dtype=np.uint32)[None, :]

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    code = spread(xs) | (spread(ys) << np.uint64(1))
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def ray_directions_morton(spec: CameraSpec, cam: CameraState, frame: int,
                          key) -> torch.Tensor:
    """Planar (3, N) unit directions of the whole film in static morton
    lane order, with the raster path's per-pixel jitter."""
    W, H = spec.width, spec.height
    perm, _ = morton_pixel_order(W, H)
    dev = cam.eye.device
    px = torch.as_tensor((perm // H).astype(np.float32), device=dev)
    py = torch.as_tensor((perm % H).astype(np.float32), device=dev)
    return ray_directions_from_pixels(spec, cam, frame, key, px, py)


def ray_directions_from_pixels(spec: CameraSpec, cam: CameraState, frame: int,
                               key, px, py) -> torch.Tensor:
    """Planar (3, n) primary directions for pixel coordinates (px, py)."""
    dw = _camera_dirs(spec, cam, frame, key, px, py)
    inv_len = torch.rsqrt(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2])
    return dw * inv_len[None, :]


def _camera_dirs(spec: CameraSpec, cam: CameraState, frame: int, key, px, py):
    """Planar (3, n) unnormalised world directions through pixels (px, py):
    a uniform +-0.5 px jitter box (off on frame 0), then the camera
    rotation as explicit multiply-adds (no matmul that TF32 could reach
    on the card)."""
    n = px.shape[0]
    jit = rng.uniform(key, (2, n), device=px.device) - 0.5
    on = 1.0 if int(frame) != 0 else 0.0
    x = (px + jit[0] * on - spec.cx) / spec.fx
    y = (py + jit[1] * on - spec.cy) / spec.fy
    r3 = cam.view_inv[:3, :3]
    return r3[:, 0:1] * x[None, :] + r3[:, 1:2] * y[None, :] - r3[:, 2:3]
