"""The host dict of the single-model glass scene (the port's
examples/scenes.single_model_host as the benchmark froze it): the
reference's example/single_model.py, model/sphere.obj (2,280 triangles,
each of its 760 stored three times, kept as shipped) with smooth normals
as glass (ior 1.3, extinction 5), under a sphere light and the env map
at power 5."""

from reference.plain.core import constants as C
from reference.plain.examples.scenes import _add_sphere_light
from reference.plain.io.assets import asset_path
from reference.plain.scene.build import MaterialRec, SceneBuilder


def single_model_host() -> dict:
    """Host dict of the glass sphere (sphere.obj, smooth normals, ior 1.3,
    extinction 5) under a sphere light and the env map at power 5."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/sphere.obj"))
    b.materials[0] = MaterialRec(C.MAT_GLASS, color=b.materials[0].color, p0=1.3, p1=5.0)
    _add_sphere_light(b)
    b.add_env(asset_path("image/env.png"), 5.0)
    return b.build_host(smooth_normals=True)
