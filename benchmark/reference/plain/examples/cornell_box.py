"""The host dict of the classic Cornell box (the port's
examples/scenes.cornell_box_host as the benchmark froze it): the
reference's example/cornell_box.py, model/cornell_box.obj with its
materials (36 triangles, the area light among them)."""

from reference.plain.io.assets import asset_path
from reference.plain.scene.build import SceneBuilder


def cornell_box_host() -> dict:
    """Host dict of the classic box (cornell_box.obj, 36 triangles)."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/cornell_box.obj"))
    return b.build_host()
