"""The host dict of the prism dispersion demo (the port's
examples/scenes.prism_rainbow_host as the benchmark froze it): the
reference's example/prism_rainbow.py, model/prism1.obj (3,152 triangles,
no smooth normals) under a sphere light and a laser, with the spectral
pack rows.  The laser is written out as its shape record, as the port's
scene/build.laser_shape makes it (the frozen scene/build.py has no
such helper)."""

from reference.plain.core import constants as C
from reference.plain.io.assets import asset_path
from reference.plain.scene.build import MaterialRec, SceneBuilder, ShapeRec, sphere_shape


def prism_rainbow_host() -> dict:
    """Host dict of the dispersion demo: prism1.obj under a sphere light
    and, aimed at the prism along -z, a laser of radius 0.1, both of
    emission (500, 500, 500); spectral pack rows."""
    b = SceneBuilder()
    b.add_obj(asset_path("model/prism1.obj"))
    b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0),
                MaterialRec(C.MAT_LIGHT, color=[500.0] * 3))
    # a collimated beam of radius 0.1 from (1, 0, 9) along (0, 0, -1)
    b.add_shape(ShapeRec(C.SHAPE_LASER, [1.0, 0.0, 9.0], [0.1, 0.0, 0.0, 0.0, 0.0, -1.0]),
                MaterialRec(C.MAT_LIGHT, color=[500.0] * 3))
    return b.build_host(spectral=True)
