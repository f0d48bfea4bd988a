"""Whole BDPT frames of the port against the JAX package on the CPU: the
Veach scene at 16^2, max_depth 2 (eye walks of 4 vertices, light walks of
3), from one seed through `render_frame` (both estimators) and
`render_frame_sliced` (exact, and with walk compaction of both fronts
before depth 2, whose overflow must be equal); and once at the golden's
MAX_DEPTH 5 through `render_frame` (the reference estimator), so the
strategies of depth 3-5 are held to JAX as well.  Bar, as for the path
tracer's renders: >= 98% of pixels within rtol 1e-3 and image means
within 1% (ulp differences between XLA's fused multiply-adds and the
port's rounding flip a discrete decision now and then, and with it a
whole path's contribution).  The module-level units are in
test_torch_bdpt.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nee import _cameras, scenes  # noqa: F401  (fixture)
from ti_raytrace_tpu.integrators import bdpt_rgb as jbd
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import bdpt_rgb as tbd

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["reference", "corrected", "depth5", "sliced",
                                  "sliced_compact"])
def test_render_matches_reference(scenes, case):  # noqa: F811
    js, ts, _, _ = scenes
    (jspec, jcam), (tspec, tcam) = _cameras(js, ts, 16)
    seed = 21
    jkey, tkey = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    if case in ("reference", "corrected", "depth5"):
        corrected = case == "corrected"
        depth = 5 if case == "depth5" else 2
        want = jbd.render_frame(js, jspec, jcam, jnp.int32(1), jkey, corrected=corrected,
                                max_depth=depth)
        got, overflow = tbd.render_frame(ts, tspec, tcam, 1, tkey, corrected=corrected,
                                         max_depth=depth, return_overflow=True)
        assert int(overflow) == 0
    else:
        sched = (((2, 2),), ((2, 2),)) if case == "sliced_compact" else None
        want, jov = jbd.render_frame_sliced(js, jspec, jcam, jnp.int32(1), jkey, 2,
                                            max_depth=2, walk_compaction=sched,
                                            return_overflow=True)
        got, overflow = tbd.render_frame_sliced(ts, tspec, tcam, 1, tkey, 2, max_depth=2,
                                                walk_compaction=sched, return_overflow=True)
        assert int(overflow) == int(jov)
    a, b = got.numpy(), np.asarray(want)
    assert a.shape == b.shape == (16, 16, 3)
    assert b.mean() > 0.01
    assert np.isclose(a, b, rtol=1e-3, atol=0.0).all(axis=-1).mean() >= 0.98
    assert abs(a.mean() - b.mean()) <= 0.01 * b.mean()
