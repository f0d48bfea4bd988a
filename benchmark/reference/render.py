"""The plain reference of a benchmark cell: the scene, the camera and the
calls of the cell's traffic, worked out again from the configuration file
by the frozen plain copy of the renderer in `reference/plain/`.

Nothing here imports the program: the scene is built from the assets by
the copy's own builder (its clusters and tables included), the camera
from the configuration's framing, and the key chain from the seed.  The
copy traces with plain tensor ops (no kernel), so it runs on any device.
The control, the same reference in bfloat16, is `control.py`.
"""

import importlib
from dataclasses import dataclass

from reference.plain import film as film_mod
from reference.plain.core import rng
from reference.plain.examples import scenes
from reference.plain.scene.data import device_scene


def example_config(config: dict):
    """The configuration file's `example` settings as the copy's
    ExampleConfig (JSON lists become the tuples the integrators take)."""
    def tup(x):
        return tuple(tup(v) for v in x) if isinstance(x, list) else x

    return scenes.ExampleConfig(**{k: tup(v) for k, v in config["example"].items()})


@dataclass
class Reference:
    scene: object
    cfg: object
    spec: object
    cam: object
    integrator: str


def build(config: dict, workload: dict, device) -> Reference:
    """The reference's scene (built from the assets by the frozen host
    builder that the configuration's `host` names, "<module>:<function>"
    of reference/plain/examples/), its ExampleConfig and camera at the
    workload's resolution."""
    module, name = config["host"].split(":")
    host = getattr(importlib.import_module("reference.plain.examples." + module), name)()
    scene = device_scene(host, device)
    cfg = example_config(config)
    spec, cam = scenes.make_camera(scene, cfg, workload["width"], workload["height"])
    return Reference(scene, cfg, spec, cam, workload["integrator"])


def render_call(ref: Reference, fl, n: int):
    """n frames into the film `fl` as the CLI's render_batch dispatches
    them for the cell's integrator (`reference/calls/<integrator>.py`).
    Returns (film', overflow)."""
    return importlib.import_module("reference.calls." + ref.integrator).render_call(ref, fl, n)


def replay(ref: Reference, hdr, frame: int, key, n: int):
    """The film after one call of n frames that starts from the film
    (hdr, frame, key): what the program's call should have produced."""
    fl = film_mod.Film(hdr=hdr.to(ref.scene.device), frame=frame, key=key)
    fl, overflow = render_call(ref, fl, n)
    return fl, overflow


def key_at(seed: int, frame: int):
    """The film's key before `frame`: the seed's key split `frame` times,
    as the film's accumulation advances it."""
    key = rng.PRNGKey(seed)
    for _ in range(frame):
        key = rng.split(key)[0]
    return key
