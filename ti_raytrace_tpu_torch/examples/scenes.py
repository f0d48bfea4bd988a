"""Scene configs (twin of ti_raytrace_tpu/examples/scenes.py): the
100k-triangle benchmark and the Veach MIS scene; the other reference
scenes are ROADMAP 'to port' items.  Each function returns (SceneData on
`device`, ExampleConfig)."""

import os
from dataclasses import dataclass

import numpy as np

from ti_raytrace_tpu_torch.camera import CameraSpec, orbit_camera
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.io.assets import asset_path
from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder, sphere_shape

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
)


@dataclass
class ExampleConfig:
    name: str
    integrator: str = "pt_rgb"  # the scene's own integrator (CLI --integrator overrides)
    scale_mult: float = 0.8     # camera distance = diag * scale_mult
    exposure: float = 0.5
    compaction: tuple | None = None  # wavefront compaction schedule
    group: int | None = None    # merged-group size of the production path
    pay_divisors: tuple | None = None  # fused flush+compact tail capacities
    batch: int | None = None    # frames per CLI dispatch (None: 8 for PT, 4 for BDPT)
    # BDPT walk compaction (eye schedule, light schedule) and shadow-batch
    # cap, the bdpt_rgb render contract (None: exact)
    bdpt_walk_compaction: tuple | None = None
    bdpt_shadow_cap: float | None = None


BENCH_SCHEDULE_MERGED = ((1, 5), (3, 24), (8, 128))
"""Compaction schedule of the merged bench path: wavefront widths
N/5 after bounce 1, N/24 after bounce 3, N/128 after bounce 8 (tuned on
the reference's hardware with zero overflow kills; the port reports its
own kill count)."""

BENCH_PAY_DIVISORS = (8, 32)
"""Payload-tail capacities (N/8, N/32) of the fused flush+compact at the
two merged phase boundaries."""

BENCH_GROUP = 16
"""Frames per merged group on the bench path."""


def benchmark_100k_host(n_target: int = 100_000) -> dict:
    """Host dict of the benchmark: a Teapot densified to >= n_target
    triangles, all glass (ior 1.3, extinction 5), a sphere light and the
    env map at power 5."""
    from ti_raytrace_tpu_torch.io.meshgen import densify_to
    from ti_raytrace_tpu_torch.io.obj import load_obj

    mesh = load_obj(asset_path("model/Teapot.obj"))
    pos, nrm, uv = densify_to(np.concatenate(mesh.tri_pos),
                              np.concatenate(mesh.tri_normal),
                              np.concatenate(mesh.tri_uv), n_target)
    b = SceneBuilder()
    b.add_triangles(pos, nrm, uv,
                    MaterialRec(C.MAT_GLASS, color=(0.8, 0.8, 0.8), p0=1.3, p1=5.0))
    b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
    b.add_env(asset_path("image/env.png"), 5.0)
    return b.build_host()


def benchmark_100k(device="cpu", n_target: int = 100_000):
    """(SceneData on `device`, ExampleConfig) of the headline benchmark.
    The host arrays are cached under .cache/ keyed by the triangle target
    and BUILD_FORMAT_VERSION (a file name of its own: the reference's
    cache holds BVH keys this builder does not make)."""
    from ti_raytrace_tpu_torch.scene.build import BUILD_FORMAT_VERSION
    from ti_raytrace_tpu_torch.scene.data import device_scene

    cfg = ExampleConfig("benchmark_100k", "pt_rgb", scale_mult=0.8,
                        compaction=BENCH_SCHEDULE_MERGED, group=BENCH_GROUP,
                        pay_divisors=BENCH_PAY_DIVISORS)
    path = os.path.join(_CACHE_DIR,
                        f"torch_bench_scene_{n_target}_v{BUILD_FORMAT_VERSION}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            host = {k: z[k] for k in z.files}
    else:
        host = benchmark_100k_host(n_target)
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"  # np.savez appends .npz
        np.savez(tmp, **host)
        os.replace(tmp, path)  # atomic publish: a torn npz is never read
    return device_scene(host, device), cfg


def veach_host() -> dict:
    """Host dict of the Veach MIS scene: bdpt.obj (11,544 triangles, four
    emissive triangles) with smooth normals, no environment."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/bdpt.obj"))
    return b.build_host(smooth_normals=True)


def veach_bdpt(device="cpu"):
    """The Veach MIS scene (the reference's example/veach_bdpt.py).  Its
    own integrator is BDPT (`bdpt_rgb`, no walk compaction, no shadow
    cap: the exact estimator); `--integrator pt_rgb` renders it with the
    unidirectional tracer and NEE (the reference's veach_pt golden), on
    the exact path."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(veach_host(), device), ExampleConfig(
        "veach_bdpt", "bdpt_rgb", scale_mult=0.5)


EXAMPLES = {"benchmark_100k": benchmark_100k, "veach_bdpt": veach_bdpt}


def framing_params(scene, cfg: ExampleConfig):
    """The example's framing rule as orbit-rig parameters (target, yaw,
    pitch, scale): the scene box centre, seen along -z from diag *
    scale_mult away."""
    lo = scene.aabb_min.cpu().numpy()
    hi = scene.aabb_max.cpu().numpy()
    centre = 0.5 * (lo + hi)
    scale = float(np.linalg.norm(hi - lo)) * cfg.scale_mult
    return centre, 0.0, 0.0, scale


def make_camera(scene, cfg: ExampleConfig, width: int, height: int):
    """(CameraSpec, CameraState on the scene's device)."""
    target, yaw, pitch, scale = framing_params(scene, cfg)
    return (CameraSpec(width, height),
            orbit_camera(target, yaw, pitch, scale, device=scene.device))
