"""The spectral BDPT frame replayed from a CUDA graph
(`integrators/bdpt_spec.FrameGraph`) and the device keys it draws with
(`core/rng.DeviceKey`, csrc/rng.cu's device-key kernels).

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_frame_graph.py -m gpu --noconftest -p no:cacheprovider

The CPU cases hold the device-key chain (split, fold_in, uniform) to the
host chain bit for bit, render a prism frame with a device key equal to
the host key's, and check when `render_film_frames` replays a graph and
which graph it keeps.  The `gpu` cases hold the device-key kernels to the
host chain and the graph's frames and films to the eager ones, bit for
bit.
"""

import pytest
import torch

from ti_raytrace_tpu_torch import film, metrics
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.examples import run, scenes
from ti_raytrace_tpu_torch.integrators import bdpt_spec

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEEDS = (0, 2999999929, 2**32 - 1)


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _device_key(key, device):
    return rng.DeviceKey(key.clone().to(device))


def _chain(key, device):
    """The keys and draws of a BDPT frame's chain shapes, from `key`."""
    k_lam, k_path = rng.split(key)
    k_eye, k_light, k_conn = rng.split(k_path, 3)
    folded = [rng.fold_in(k_conn, d) for d in (0, 5, 16 * 6 + 5, 2**32 - 1)]
    keys = [k_lam, k_eye, k_light, *rng.split(k_eye, 4), *folded]
    draws = [rng.uniform(k, shape, device=device)
             for k, shape in zip(keys, [(7,), (2, 300), (6, 256), (5, 129), (3, 1000)] * 3)]
    return keys, draws


@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_chain_equals_the_host_chain(seed):
    """split, fold_in and uniform of a DeviceKey (int64 tensor ops on the
    CPU) give the host chain's words and bits."""
    key = rng.PRNGKey(seed)
    host_keys, host_draws = _chain(key, CPU)
    dev_keys, dev_draws = _chain(_device_key(key, CPU), CPU)
    assert all(isinstance(k, rng.DeviceKey) for k in dev_keys)
    for h, d in zip(host_keys, dev_keys):
        assert torch.equal(h, d.words)
    for h, d in zip(host_draws, dev_draws):
        assert torch.equal(_bits(h), _bits(d))


def test_device_key_split_is_a_list():
    keys = rng.split(_device_key(rng.PRNGKey(3), CPU), 4)
    assert isinstance(keys, list) and len(keys) == 4
    assert [tuple(k.words.shape) for k in keys] == [(2,)] * 4


@pytest.fixture(scope="module")
def prism():
    scene, cfg = scenes.example_cached("prism_rainbow", CPU)
    spec, cam = scenes.make_camera(scene, cfg, 16, 16)
    return scene, cfg, spec, cam, run.spectral_data(cfg, "bdpt_spec", CPU)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_prism_frame_with_a_device_key_equals_the_host_key(prism, seed):
    """What the graph captures: a spectral BDPT frame drawn through a
    DeviceKey is the host key's frame, bit for bit (here on the CPU)."""
    scene, _, spec, cam, render_frame = prism
    key = rng.split(rng.PRNGKey(seed))[0]
    img, ov = render_frame(scene, spec, cam, 3, key, return_overflow=True)
    img_d, ov_d = render_frame(scene, spec, cam, 3, _device_key(key, CPU), return_overflow=True)
    assert torch.equal(_bits(img), _bits(img_d)) and int(ov) == int(ov_d)


def test_cpu_films_capture_no_graph(prism, monkeypatch):
    scene, _, spec, cam, render_frame = prism
    monkeypatch.setattr(bdpt_spec, "FrameGraph", lambda *a: pytest.fail("captured"))
    fl = film.new_film(16, 16, seed=4, device=CPU)
    fl, _ = bdpt_spec.render_film_frames(scene, spec, cam, fl, render_frame, n_frames=2)
    assert fl.frame == 2


class FakeGraph(bdpt_spec.FrameGraph):
    """A FrameGraph that captures nothing: counts its captures."""

    made = []

    def __init__(self, render_frame, scene, spec, cam):
        self.inputs = (scene, spec, cam)
        FakeGraph.made.append(self.inputs)


def test_a_renderer_keeps_the_graph_of_its_last_inputs(prism, monkeypatch):
    scene, cfg, spec, cam, _ = prism
    monkeypatch.setattr(bdpt_spec, "FrameGraph", FakeGraph)
    FakeGraph.made.clear()

    def render_frame(*a, **k):
        raise AssertionError("not rendered")

    g = bdpt_spec._frame_graph(render_frame, scene, spec, cam)
    assert bdpt_spec._frame_graph(render_frame, scene, spec, cam) is g
    spec2, cam2 = scenes.make_camera(scene, cfg, 16, 16)
    assert bdpt_spec._frame_graph(render_frame, scene, spec2, cam) is g  # an equal spec
    g2 = bdpt_spec._frame_graph(render_frame, scene, spec, cam2)
    assert g2 is not g and render_frame.frame_graph is g2
    assert len(FakeGraph.made) == 2


# ---------------------------------------------------------------- the card

@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_kernels_equal_the_host_chain(cuda, seed):
    """The device-key kernels on the card: the host chain's words and
    draws, bit for bit; one launch a derivation and a draw."""
    dev = torch.device("cuda", torch.cuda.current_device())
    key = rng.PRNGKey(seed)
    host_keys, host_draws = _chain(key, dev)
    metrics.clear_spans()
    with metrics.recording():
        dev_keys, dev_draws = _chain(_device_key(key, dev), dev)
    launches = metrics.kernel_launches("rng.uniform", "n")
    metrics.clear_spans()
    torch.cuda.synchronize()
    for h, d in zip(host_keys, dev_keys):
        assert torch.equal(h, d.words.cpu())
    for h, d in zip(host_draws, dev_draws):
        assert torch.equal(_bits(h), _bits(d))
    assert sum(launches.values()) == len(dev_draws)


@pytest.fixture(scope="module")
def prism_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    scene, cfg = scenes.example_cached("prism_rainbow", dev)
    spec, cam = scenes.make_camera(scene, cfg, 64, 64)
    return scene, cfg, spec, cam, run.spectral_data(cfg, "bdpt_spec", dev)


@pytest.mark.gpu
def test_graph_replays_equal_eager_frames(prism_card):
    """Replays of one FrameGraph under two keys and again under the first:
    each the eager frame of that key, bit for bit, overflow included."""
    scene, _, spec, cam, render_frame = prism_card
    graph = bdpt_spec.FrameGraph(render_frame, scene, spec, cam)
    keys = [rng.split(rng.PRNGKey(s))[0] for s in (11, 2999999929, 11)]
    for key in keys:
        img, ov = graph(key)
        img, ov = img.clone(), ov.clone()
        want, want_ov = render_frame(scene, spec, cam, 5, key, return_overflow=True)
        assert torch.equal(_bits(img), _bits(want)) and int(ov) == int(want_ov)


@pytest.mark.gpu
def test_graphed_film_equals_the_recorded_eager_film(prism_card):
    """render_film_frames replays the graph unless spans record, when it
    runs every frame eagerly: the two films are equal bit for bit, and
    the renderer keeps one graph across calls."""
    scene, _, spec, cam, render_frame = prism_card
    render_frame.frame_graph = None
    graphed = film.new_film(64, 64, seed=2147483659, device=scene.device)
    for _ in range(2):
        graphed, ov = bdpt_spec.render_film_frames(scene, spec, cam, graphed, render_frame, 3)
        assert ov == 0
    kept = render_frame.frame_graph
    assert kept is not None
    eager = film.new_film(64, 64, seed=2147483659, device=scene.device)
    with metrics.recording():
        for _ in range(2):
            eager, _ = bdpt_spec.render_film_frames(scene, spec, cam, eager, render_frame, 3)
    metrics.clear_spans()
    assert render_frame.frame_graph is kept
    assert graphed.frame == eager.frame == 6
    assert torch.equal(graphed.key, eager.key)
    assert torch.equal(_bits(graphed.hdr), _bits(eager.hdr))
