"""The control of `correct`: the plain reference put in the program's place
and computed one precision below the configuration's float32, in
bfloat16, at the step that would tempt a later change: the tracer's rays
and hit records and the sampler's uniforms held in bfloat16 (a bf16
wavefront carry).  The comparison has to call it not correct.

`Control` has the program's interface (harness/program.Program): a run
of the harness with it in the program's place reads the control's
numbers."""

import contextlib

import numpy as np
import torch

from reference import render
from reference.plain import film as film_mod
from reference.plain.core import rng
from reference.plain.ops import cluster_trace

_BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _bf16(x):
    return None if x is None else x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def bfloat16():
    """Inside the block the reference traces bf16-rounded rays (origins,
    directions, tmax), rounds the hit distances and barycentrics to bf16,
    and draws bf16-rounded uniforms (kept below 1)."""
    trace, uniform = cluster_trace.trace_clustered, rng.uniform

    def trace_bf16(scene, o, d, *args, tmax=None, **kw):
        out = trace(scene, _bf16(o), _bf16(d), *args, tmax=_bf16(tmax), **kw)
        t, prim, uv = out[0], out[1], out[2]
        return (_bf16(t), prim, _bf16(uv)) + tuple(out[3:])

    def uniform_bf16(key, shape, device=None):
        return torch.clamp(_bf16(uniform(key, shape, device)), max=_BELOW_ONE)

    cluster_trace.trace_clustered, rng.uniform = trace_bf16, uniform_bf16
    try:
        yield
    finally:
        cluster_trace.trace_clustered, rng.uniform = trace, uniform


class Control:
    """The reference of a cell in bfloat16, with the program's interface."""

    def __init__(self, config: dict, workload: dict, device):
        self.ref = render.build(config, workload, device)
        self.device = device
        self.exposure = self.ref.cfg.exposure

    def new_film(self, seed: int):
        return film_mod.new_film(self.ref.spec.width, self.ref.spec.height, seed=seed,
                                 device=self.device)

    def call(self, fl, n: int):
        with bfloat16():
            return render.render_call(self.ref, fl, n)

    def readback(self, fl):
        srgb = film_mod.to_srgb(fl, exposure=self.exposure).cpu().numpy()
        return (srgb * 255.0).astype(np.uint8)
