"""The BVH oracle on the card against itself on the CPU: the LBVH build
of accel/lbvh.py bit-equal (morton codes divide in IEEE f32 on both, the
sort is stable on both, min/max are exact), and trace_closest on a Teapot
wavefront (misses and prim ids equal, t within rtol 1e-5: CUDA may fuse a
multiply-add where the CPU rounds).  Imports no JAX, so it runs on the
GPU machine too:

    python -m pytest tests/test_torch_bvh_gpu.py -m gpu --noconftest -p no:cacheprovider

Without a card both cases skip.
"""

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch.accel import lbvh, traverse
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.io.assets import asset_path
from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder, sphere_shape
from ti_raytrace_tpu_torch.scene.data import device_scene


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def teapot_host():
    b = SceneBuilder()
    b.add_obj(asset_path("model/Teapot.obj"))
    b.add_shape(sphere_shape([0.0, 20.0, 0.0], 5.0), MaterialRec(C.MAT_LIGHT, color=[50.0] * 3))
    return b.build_host()


def _prim_boxes(host):
    v0, e1, e2 = (host[k] for k in ("tri_v0", "tri_e1", "tri_e2"))
    corners = np.stack([v0, v0 + e1, v0 + e2])
    return corners.min(0), corners.max(0)


def _rays(host, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = host["aabb_min"], host["aabb_max"]
    o = (0.5 * (lo + hi) + rng.uniform(-1.2, 1.2, (n, 3)) * (hi - lo)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))


@pytest.mark.gpu
def test_lbvh_on_cuda_equals_cpu(teapot_host, cuda):
    args = [torch.from_numpy(np.asarray(x)) for x in (
        *_prim_boxes(teapot_host), teapot_host["aabb_min"], teapot_host["aabb_max"])]
    cpu = lbvh.build_lbvh_device(*args)
    gpu = lbvh.build_lbvh_device(*(a.cuda() for a in args))
    for k in ("sorted_idx", "left", "right", "leaf_min", "leaf_max", "int_min", "int_max"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert gpu["iterations"] == cpu["iterations"]


@pytest.mark.gpu
def test_trace_closest_on_cuda_equals_cpu(teapot_host, cuda):
    o, d = _rays(teapot_host, 4096, 1)
    t, p = traverse.trace_closest(device_scene(teapot_host, "cpu"), o, d)
    tg, pg = traverse.trace_closest(device_scene(teapot_host, "cuda"), o.cuda(), d.cuda())
    tg, pg = tg.cpu(), pg.cpu()
    assert (p >= 0).sum() > 300
    assert torch.equal(pg, p)
    torch.testing.assert_close(tg, t, rtol=1e-5, atol=0.0)
