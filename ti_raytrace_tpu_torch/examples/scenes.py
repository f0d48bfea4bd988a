"""Scene configs (twin of ti_raytrace_tpu/examples/scenes.py): the
100k-triangle benchmark, the Veach MIS scene, the four path-traced scenes
of the dense tracer (cornell_box, single_model, sky_dome, spectral_box)
and the prism dispersion demo under spectral BDPT (prism_rainbow).  Each
`*_host` function builds the scene's host dict; each scene function returns
(SceneData on `device`, ExampleConfig), from `host` where given (the
cached dict of `example_cached`).  The schedules, groups and
batches are the reference's, sized there for zero overflow kills (the
occupancy they rest on belongs to the scene and the random stream); the
port reports its own kill count."""

import os
from dataclasses import dataclass, field

import numpy as np

from ti_raytrace_tpu_torch.camera import CameraSpec, orbit_camera
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.io.assets import asset_path
from ti_raytrace_tpu_torch.scene.build import (
    MaterialRec,
    SceneBuilder,
    laser_shape,
    sphere_shape,
)

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
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


def _add_sphere_light(b: SceneBuilder, emission=50.0):
    b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                MaterialRec(C.MAT_LIGHT, color=[emission] * 3))


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
    _add_sphere_light(b)
    b.add_env(asset_path("image/env.png"), 5.0)
    return b.build_host()


def cached_host_build(key: str, make_host) -> dict:
    """Host dict from `make_host()` through an npz cache under .cache/,
    keyed by `key` and BUILD_FORMAT_VERSION (file names of the port's own,
    apart from the reference's caches).  A cache written before the
    builder made the BVH (no `bvh_prim`) is a miss and is rebuilt; a new
    cache is published atomically, so concurrent ranks building the same
    scene never read a torn file."""
    from ti_raytrace_tpu_torch.scene.build import BUILD_FORMAT_VERSION

    path = os.path.join(_CACHE_DIR, f"torch_{key}_v{BUILD_FORMAT_VERSION}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            if "bvh_prim" in z.files:
                return {k: z[k] for k in z.files}
    host = make_host()
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"  # np.savez appends .npz
    np.savez(tmp, **host)
    os.replace(tmp, path)  # atomic publish: a torn npz is never read
    return host


def benchmark_100k_cached_host(n_target: int = 100_000) -> dict:
    """benchmark_100k_host through cached_host_build, keyed by the
    triangle target."""
    return cached_host_build(f"bench_scene_{n_target}", lambda: benchmark_100k_host(n_target))


def benchmark_100k(device="cuda", n_target: int = 100_000):
    """(SceneData on `device`, ExampleConfig) of the headline benchmark,
    from benchmark_100k_cached_host."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    cfg = ExampleConfig("benchmark_100k", "pt_rgb", scale_mult=0.8,
                        compaction=BENCH_SCHEDULE_MERGED, group=BENCH_GROUP,
                        pay_divisors=BENCH_PAY_DIVISORS)
    return device_scene(benchmark_100k_cached_host(n_target), device), cfg


def veach_host() -> dict:
    """Host dict of the Veach MIS scene: bdpt.obj (11,544 triangles, four
    emissive triangles) with smooth normals, no environment."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/bdpt.obj"))
    return b.build_host(smooth_normals=True)


def veach_bdpt(device="cuda", host=None):
    """The Veach MIS scene (the reference's example/veach_bdpt.py).  Its
    own integrator is BDPT (`bdpt_rgb`, no walk compaction, no shadow
    cap: the exact estimator); `--integrator pt_rgb` renders it with the
    unidirectional tracer and NEE (the reference's veach_pt golden), on
    the exact path."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(veach_host() if host is None else host, device), ExampleConfig(
        "veach_bdpt", "bdpt_rgb", scale_mult=0.5)


def cornell_box_host() -> dict:
    """Host dict of the classic box (cornell_box.obj, 36 triangles)."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/cornell_box.obj"))
    return b.build_host()


def cornell_box(device="cuda", host=None):
    """pt_rgb with NEE on the classic box, four compaction phases, 32
    frames per dispatch."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(cornell_box_host() if host is None else host, device), ExampleConfig(
        "cornell_box", "pt_rgb", scale_mult=0.8,
        compaction=((3, 2), (5, 4), (8, 8), (11, 16)), batch=32)


def single_model_host() -> dict:
    """Host dict of the glass sphere (sphere.obj, smooth normals, ior 1.3,
    extinction 5) under a sphere light and the env map at power 5."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/sphere.obj"))
    b.materials[0] = MaterialRec(C.MAT_GLASS, color=b.materials[0].color, p0=1.3, p1=5.0)
    _add_sphere_light(b)
    b.add_env(asset_path("image/env.png"), 5.0)
    return b.build_host(smooth_normals=True)


def single_model(device="cuda", host=None):
    """pt_rgb on the glass sphere in merged groups of 16: N/4 lanes after
    bounce 1 (about 22% of the camera rays hit the sphere), N/128 after
    bounce 3."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(single_model_host() if host is None else host, device), ExampleConfig(
        "single_model", "pt_rgb", scale_mult=0.8,
        compaction=((1, 4), (3, 128)), group=16, batch=64)


def sky_dome_host() -> dict:
    """Host dict of the mirror sphere (sphere.obj, metallic 1, roughness
    0) under a sphere light, with the spectral pack rows."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/sphere.obj"))
    b.materials[0].p0 = 1.0  # metallic
    b.materials[0].p1 = 0.0  # roughness
    _add_sphere_light(b)
    return b.build_host(smooth_normals=True, spectral=True)


def sky_dome(device="cuda", host=None):
    """pt_spec: the mirror sphere under the Hosek-Wilkie sky (turbidity 3,
    albedo 0.5, elevation 0.17, the reference integrator's sky).  A
    depth-2 scene: about 4.6% of the camera rays hit the sphere and their
    reflections leave into the sky, so one phase of N/16 lanes after
    bounce 1."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(sky_dome_host() if host is None else host, device), ExampleConfig(
        "sky_dome", "pt_spec", scale_mult=2.0,
        sky=dict(turbidity=3.0, albedo=0.5, elevation=0.17),
        compaction=((1, 16),), batch=64)


def spectral_box_host() -> dict:
    """Host dict of the hero-wavelength cornell box: the first three
    materials become measured-SPD reflectors (0 white, 1 red, 2 green)."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/cornell_box.obj"))
    for i in range(3):
        b.materials[i].type = C.MAT_SPECTRAL
        b.materials[i].tex = i
    return b.build_host(smooth_normals=True, spectral=True)


def spectral_box(device="cuda", host=None):
    """pt_spec on the spectral cornell box.  emitter_scale sqrt(3): the
    scene's golden embodies a lamp scale of |Ke|_1 = 30, not the |Ke|_2 =
    17.32 of the emission formula (PARITY.md 'spectral emitter scale')."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(spectral_box_host() if host is None else host, device), ExampleConfig(
        "spectral_box", "pt_spec", scale_mult=0.8,
        sky=dict(turbidity=3.0, albedo=0.5, elevation=0.17,
                 emitter_scale=float(np.sqrt(3.0))),
        compaction=((3, 2), (6, 4), (8, 8)))


def prism_rainbow_host() -> dict:
    """Host dict of the dispersion demo: prism1.obj (3,152 triangles, no
    smooth normals) under a sphere light and, aimed at the prism along -z,
    a laser of radius 0.1, both of emission (500, 500, 500); spectral pack
    rows."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/prism1.obj"))
    b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                MaterialRec(C.MAT_LIGHT, color=[500.0] * 3))
    b.add_shape(laser_shape([1.0, 0.0, 9.0], [0.0, 0.0, -1.0], 0.1),
                MaterialRec(C.MAT_LIGHT, color=[500.0] * 3))
    return b.build_host(spectral=True)


def prism_rainbow(device="cuda", host=None):
    """Spectral BDPT (`bdpt_spec`) on the prism and the laser, seen from a
    fixed distance of 10 towards the origin.  emitter_scale sqrt(3): both
    lights are gray, and the scene's golden embodies the |Ke|_1 lamp scale
    (as spectral_box's does).  The walk fronts shrink at depths 2, 3 and 4
    (eye to N/1.7, N/5.5, N/10; light to N/1.6, N/2.4, N/3.9) and the
    shadow batch is swept at 0.09 of its lanes: the reference's schedules,
    sized there from the alive fractions of this scene (eye .53/.14/.07,
    light .56/.37/.22; 6.8% of the shadow lanes active); the port reports
    its own overflow."""
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(prism_rainbow_host() if host is None else host, device), ExampleConfig(
        "prism_rainbow", "bdpt_spec", fixed_scale=10.0, fixed_target=(0.0, 0.0, 0.0),
        sky=dict(emitter_scale=float(np.sqrt(3.0))),
        bdpt_walk_compaction=(((2, 1.7), (3, 5.5), (4, 10.0)),
                              ((2, 1.6), (3, 2.4), (4, 3.9))),
        bdpt_shadow_cap=0.09)


EXAMPLES = {
    "cornell_box": cornell_box,
    "single_model": single_model,
    "sky_dome": sky_dome,
    "spectral_box": spectral_box,
    "veach_bdpt": veach_bdpt,
    "prism_rainbow": prism_rainbow,
    "benchmark_100k": benchmark_100k,
}


_HOSTS = {
    "cornell_box": cornell_box_host,
    "single_model": single_model_host,
    "sky_dome": sky_dome_host,
    "spectral_box": spectral_box_host,
    "veach_bdpt": veach_host,
    "prism_rainbow": prism_rainbow_host,
}


def example_cached(name: str, device="cuda"):
    """EXAMPLES[name](device) with the host dict through cached_host_build
    (the benchmark has its own cache), so repeated processes (the ranks of
    parallel/dryrun.py) load an npz instead of rebuilding the scene."""
    if name == "benchmark_100k":
        return benchmark_100k(device)
    if name not in EXAMPLES:
        raise ValueError(f"unknown scene {name!r} (scenes: {sorted(EXAMPLES)})")
    return EXAMPLES[name](device, host=cached_host_build(f"scene_{name}", _HOSTS[name]))


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
