"""Scene configs (the port's examples/scenes.py as the benchmark froze it,
without its npz cache), cut to the benchmark's scenes: the host dicts of
the 100k-triangle benchmark and of the Veach MIS scene, and the
ExampleConfig that a configuration file fills."""

from dataclasses import dataclass, field

import numpy as np

from reference.plain.camera import CameraSpec, orbit_camera
from reference.plain.core import constants as C
from reference.plain.io.assets import asset_path
from reference.plain.scene.build import (
    MaterialRec,
    SceneBuilder,
    sphere_shape,
)


@dataclass
class ExampleConfig:
    name: str
    integrator: str = "pt_rgb"  # the scene's own integrator (CLI --integrator overrides)
    scale_mult: float = 0.8     # camera distance = diag * scale_mult
    fixed_scale: float | None = None  # camera distance as given (scale_mult unused)
    fixed_target: tuple | None = None  # with fixed_scale: the look-at point (None: origin)
    yaw: float = 0.0
    pitch: float = 0.0
    exposure: float = 0.5
    # pt_spec.make_spectral_data parameters; bdpt_spec reads its emitter_scale
    sky: dict = field(default_factory=dict)
    compaction: tuple | None = None  # wavefront compaction schedule
    group: int | None = None    # merged-group size of the production path
    pay_divisors: tuple | None = None  # fused flush+compact tail capacities
    batch: int | None = None    # frames per CLI dispatch (None: 8 for PT, 4 for BDPT)
    # BDPT walk compaction (eye schedule, light schedule) and shadow-batch
    # cap, the bdpt_rgb render contract (None: exact)
    bdpt_walk_compaction: tuple | None = None
    bdpt_shadow_cap: float | None = None


"""Compaction schedule of the merged bench path: wavefront widths
N/5 after bounce 1, N/24 after bounce 3, N/128 after bounce 8 (tuned on
the reference's hardware with zero overflow kills; the port reports its
own kill count)."""

"""Payload-tail capacities (N/8, N/32) of the fused flush+compact at the
two merged phase boundaries."""

"""Frames per merged group on the bench path."""


def _add_sphere_light(b: SceneBuilder, emission=50.0):
    b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                MaterialRec(C.MAT_LIGHT, color=[emission] * 3))


def benchmark_100k_host(n_target: int = 100_000) -> dict:
    """Host dict of the benchmark: a Teapot densified to >= n_target
    triangles, all glass (ior 1.3, extinction 5), a sphere light and the
    env map at power 5."""
    from reference.plain.io.meshgen import densify_to
    from reference.plain.io.obj import load_obj

    mesh = load_obj(asset_path("model/Teapot.obj"))
    pos, nrm, uv = densify_to(np.concatenate(mesh.tri_pos),
                              np.concatenate(mesh.tri_normal),
                              np.concatenate(mesh.tri_uv), n_target)
    b = SceneBuilder()
    b.add_triangles(pos, nrm, uv,
                    MaterialRec(C.MAT_GLASS, color=(0.8, 0.8, 0.8), p0=1.3, p1=5.0))
    _add_sphere_light(b)
    b.add_env(asset_path("image/env.png"), 5.0)
    return b.build_host()


def veach_host() -> dict:
    """Host dict of the Veach MIS scene: bdpt.obj (11,544 triangles, four
    emissive triangles) with smooth normals, no environment."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/bdpt.obj"))
    return b.build_host(smooth_normals=True)


def framing_params(scene, cfg: ExampleConfig):
    """The example's framing rule as orbit-rig parameters (target, yaw,
    pitch, scale): the scene box centre seen from diag * scale_mult away,
    or, with `fixed_scale`, `fixed_target` from that distance."""
    if cfg.fixed_scale is not None:
        target = np.asarray(cfg.fixed_target or (0.0, 0.0, 0.0))
        return target, cfg.yaw, cfg.pitch, cfg.fixed_scale
    lo = scene.aabb_min.cpu().numpy()
    hi = scene.aabb_max.cpu().numpy()
    centre = 0.5 * (lo + hi)
    scale = float(np.linalg.norm(hi - lo)) * cfg.scale_mult
    return centre, cfg.yaw, cfg.pitch, scale


def make_camera(scene, cfg: ExampleConfig, width: int, height: int):
    """(CameraSpec, CameraState on the scene's device)."""
    target, yaw, pitch, scale = framing_params(scene, cfg)
    return (CameraSpec(width, height),
            orbit_camera(target, yaw, pitch, scale, device=scene.device))

