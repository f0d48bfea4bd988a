"""The port's dense sweep (ti_raytrace_tpu_torch/ops/dense_trace.py) on a
CUDA card against the same sweep on the CPU, and the tie rule on both.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_dense_gpu.py -m gpu --noconftest -p no:cacheprovider

(--noconftest: tests/conftest.py configures JAX).  Without a card the
`gpu` tests skip.  The sweep is written as multiply-adds in one order, so
CUDA and CPU must agree bit for bit on t, prim and the attribute column;
u/v are held to 1e-6 (one division's rounding could differ; none did).
"""

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops import dense_trace as dt
from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder
from ti_raytrace_tpu_torch.scene.data import device_scene

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tie_scene(copies):
    """A host dict of 140 triangles in the z = 0 plane: disjoint small
    triangles in a row, with the triangle over x in [0, 1] repeated at the
    prim indices `copies` (coincident: any ray through it hits them all at
    the same t)."""
    pos = np.zeros((140, 3, 3), np.float32)
    for i in range(140):
        x0 = 0.0 if i in copies else 2.0 + 2.0 * i
        pos[i] = [[x0, 0.0, 0.0], [x0 + 1.0, 0.0, 0.0], [x0, 1.0, 0.0]]
    b = SceneBuilder()
    b.add_triangles(pos, np.zeros_like(pos), np.zeros((140, 3, 2), np.float32),
                    MaterialRec(C.MAT_DISNEY, color=(0.5, 0.5, 0.5), p1=0.5))
    return b.build_host()


def tie_rays(n=64, seed=2):
    """Rays from z = 3 down through the shared triangle, planar (3, n)."""
    rng = np.random.default_rng(seed)
    uv = rng.random((n, 2)) * 0.45 + 0.02  # inside the triangle
    o = np.stack([uv[:, 0], uv[:, 1], np.full(n, 3.0)]).astype(np.float32)
    d = np.stack([np.zeros(n), np.zeros(n), -np.ones(n)]).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _check_ties(device):
    for copies in ((5, 77), (3, 130), (130, 3, 131)):
        scene = device_scene(tie_scene(copies), device)
        o, d = (x.to(device) for x in tie_rays())
        t, prim, uv, attr = dt.trace_shaded(scene, o, d)
        assert (prim == min(copies)).all(), copies
        assert bool((t == 3.0).all())
        assert bool(torch.isclose(attr[24], attr[24].new_tensor(0.5)).all())  # area 1/2
        np.testing.assert_allclose(uv[0].cpu().numpy(), o[0].cpu().numpy(), atol=1e-6)


def test_tie_rule_on_cpu():
    """Equal t inside one block, across two blocks and thrice: the lowest
    prim index wins."""
    _check_ties("cpu")


@pytest.mark.gpu
def test_tie_rule_on_cuda(cuda):
    _check_ties("cuda")


@pytest.mark.gpu
def test_cuda_sweep_matches_cpu_on_single_model_camera_rays(cuda):
    """The 128^2 camera wavefront of single_model (2,280 triangles + the
    light sphere): CUDA against CPU, and in lane chunks of 4096."""
    from ti_raytrace_tpu_torch.camera import ray_directions_morton
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.examples.scenes import make_camera, single_model, single_model_host

    host = single_model_host()
    outs = {}
    for dev in ("cpu", "cuda"):
        scene = device_scene(host, dev)
        _, cfg = single_model("cpu")
        spec, cam = make_camera(scene, cfg, 128, 128)
        d = ray_directions_morton(spec, cam, 1, rng.PRNGKey(4))
        o = cam.eye[:, None].expand(3, d.shape[1]).contiguous()
        if dev == "cuda":  # the same rays on both devices
            o, d = outs["rays"][0].cuda(), outs["rays"][1].cuda()
        else:
            outs["rays"] = (o, d)
        outs[dev] = tuple(x.cpu() for x in dt.trace_shaded(scene, o, d))
        if dev == "cuda":
            t_c, prim_c = dt._sweep(scene, o, d, lane_chunk=4096)
            assert torch.equal(t_c.cpu(), outs[dev][0]) and torch.equal(prim_c.cpu(), outs[dev][1])
    (t_a, p_a, uv_a, attr_a), (t_b, p_b, uv_b, attr_b) = outs["cuda"], outs["cpu"]
    assert 2000 < int((p_b >= 0).sum()) < 128 * 128
    assert torch.equal(p_a, p_b) and torch.equal(t_a, t_b) and torch.equal(attr_a, attr_b)
    torch.testing.assert_close(uv_a, uv_b, rtol=0, atol=1e-6)
