"""The system under test, ti_raytrace_tpu_torch, as the benchmark drives
it: the scene by the program's own example name (through its npz cache
in the checkout's .cache/), the configuration file's settings as the
program's ExampleConfig, and one call of the traffic through the CLI's
entry `examples.run.render_batch` (plus, for a preview workload, the
CLI's readback: `film.to_srgb`, the copy to the host and the uint8
conversion).  Nothing else of the program is read here, and the trace
hooks (`counters.py`) touch only the tracer's kernel dispatch."""

from dataclasses import dataclass

import numpy as np


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


@dataclass
class Program:
    scene: object
    cfg: object
    spec: object
    cam: object
    integrator: str
    device: object

    def new_film(self, seed: int):
        from ti_raytrace_tpu_torch import film

        return film.new_film(self.spec.width, self.spec.height, seed=seed, device=self.device)

    def call(self, fl, n: int):
        """n frames into the film as the CLI dispatches them: (film', overflow)."""
        from ti_raytrace_tpu_torch.examples.run import render_batch

        return render_batch(self.scene, self.cfg, self.spec, self.cam, fl, n, self.integrator,
                            self.cfg.group or 0)

    def readback(self, fl):
        """The preview's update: tone map, copy to the host, uint8 (what
        `run.py --preview` hands its window)."""
        from ti_raytrace_tpu_torch import film

        srgb = film.to_srgb(fl, exposure=self.cfg.exposure).cpu().numpy()
        return (srgb * 255.0).astype(np.uint8)


def setup(config: dict, workload: dict, device) -> Program:
    """The program's scene and camera for a cell, on `device`."""
    from ti_raytrace_tpu_torch.examples import scenes

    cfg = scenes.ExampleConfig(**{k: _tuples(v) for k, v in config["example"].items()})
    scene, _ = scenes.example_cached(cfg.name, device)
    spec, cam = scenes.make_camera(scene, cfg, workload["width"], workload["height"])
    return Program(scene, cfg, spec, cam, workload["integrator"], device)
