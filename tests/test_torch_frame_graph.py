"""The BDPT frames replayed from a CUDA graph (`integrators/frame_graph.py`:
the spectral frame and the sliced RGB one) and the device keys they draw
with (`core/rng.DeviceKey`, csrc/rng.cu's device-key kernels).

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_frame_graph.py -m gpu --noconftest -p no:cacheprovider

The CPU cases hold the device-key chain (split, fold_in, uniform) to the
host chain bit for bit, render a prism frame and a sliced veach_bdpt frame
with a device key equal to the host key's, and check when the film
renderers of both integrators replay a graph and which graph they keep.
The `gpu` cases hold the device-key kernels to the host chain and the
graphs' frames and films to the eager ones, bit for bit.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from ti_raytrace_tpu_torch import film, metrics
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.examples import run, scenes
from ti_raytrace_tpu_torch.integrators import bdpt_rgb, frame_graph

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
    monkeypatch.setattr(frame_graph, "FrameGraph", lambda *a: pytest.fail("captured"))
    fl = film.new_film(16, 16, seed=4, device=CPU)
    fl, _ = frame_graph.render_film_frames(scene, spec, cam, fl, render_frame, n_frames=2)
    assert fl.frame == 2


class FakeGraph(frame_graph.FrameGraph):
    """A FrameGraph that captures nothing: counts its captures, and a
    replay renders its frame function's frame eagerly."""

    made = []

    def __init__(self, render_frame, scene, spec, cam):
        self.inputs = (scene, spec, cam)
        self.render_frame = render_frame
        self.calls = 0
        FakeGraph.made.append(self.inputs)

    def __call__(self, key):
        self.calls += 1
        return self.render_frame(*self.inputs, 1, key, return_overflow=True)


def test_a_renderer_keeps_the_graph_of_its_last_inputs(prism, monkeypatch):
    scene, cfg, spec, cam, _ = prism
    monkeypatch.setattr(frame_graph, "FrameGraph", FakeGraph)
    FakeGraph.made.clear()

    def render_frame(*a, **k):
        raise AssertionError("not rendered")

    g = frame_graph.graph_of(render_frame, scene, spec, cam)
    assert frame_graph.graph_of(render_frame, scene, spec, cam) is g
    spec2, cam2 = scenes.make_camera(scene, cfg, 16, 16)
    assert frame_graph.graph_of(render_frame, scene, spec2, cam) is g  # an equal spec
    g2 = frame_graph.graph_of(render_frame, scene, spec, cam2)
    assert g2 is not g and render_frame.frame_graph is g2
    assert len(FakeGraph.made) == 2


# ------------------------------------------------------------- the RGB path

@pytest.fixture(scope="module")
def veach():
    """veach_bdpt at 8^2 on the CPU, through the cluster tracer's plain version."""
    scene, cfg = scenes.example_cached("veach_bdpt", CPU)
    spec, cam = scenes.make_camera(scene, cfg, 8, 8)
    return scene, cfg, spec, cam


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_sliced_frame_with_a_device_key_equals_the_host_key(veach, seed):
    """What the RGB graph captures: the sliced frame (its key chain split
    in four, each folded with the slice index) drawn through a DeviceKey
    is the host key's frame, bit for bit (here on the CPU)."""
    scene, cfg, spec, cam = veach
    render_frame = bdpt_rgb.sliced_frame(2, shadow_cap=cfg.bdpt_shadow_cap,
                                         walk_compaction=cfg.bdpt_walk_compaction)
    key = rng.split(rng.PRNGKey(seed))[0]
    img, ov = render_frame(scene, spec, cam, 3, key, return_overflow=True)
    img_d, ov_d = render_frame(scene, spec, cam, 3, _device_key(key, CPU), return_overflow=True)
    assert torch.equal(_bits(img), _bits(img_d)) and int(ov) == int(ov_d)


def test_rgb_cpu_films_capture_no_graph(veach, monkeypatch):
    """On the CPU every RGB frame runs eagerly: the film is the one of
    render_frame_sliced and film.accumulate, frame after frame."""
    scene, _, spec, cam = veach
    monkeypatch.setattr(frame_graph, "FrameGraph", lambda *a: pytest.fail("captured"))
    fl = film.new_film(8, 8, seed=4, device=CPU)
    got, ov = bdpt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=2, n_slices=2)
    for _ in range(2):
        fl = film.accumulate(fl, bdpt_rgb.render_frame_sliced(scene, spec, cam, fl.frame, fl.key,
                                                              2))
    assert got.frame == 2 and ov == 0
    assert torch.equal(got.key, fl.key) and torch.equal(_bits(got.hdr), _bits(fl.hdr))


@pytest.fixture
def card_stub(monkeypatch):
    """The RGB film path with a stand-in for the card: a scene whose device
    is CUDA, a sliced frame that records the frames rendered eagerly and
    returns a constant image on the CPU, and FakeGraph for FrameGraph."""
    eager = []

    def frame(scene, spec, cam, frame, key, n_slices=2, max_depth=bdpt_rgb.MAX_DEPTH,
              shadow_cap=None, walk_compaction=None, return_overflow=False):
        eager.append(frame)
        img = torch.full((spec.width, spec.height, 3), 0.25)
        return img, torch.zeros((), dtype=torch.int64)

    monkeypatch.setattr(bdpt_rgb, "render_frame_sliced", frame)
    monkeypatch.setattr(bdpt_rgb, "_sliced", None)
    monkeypatch.setattr(frame_graph, "FrameGraph", FakeGraph)
    FakeGraph.made.clear()
    scene = SimpleNamespace(device=torch.device("cuda"))
    spec = SimpleNamespace(width=4, height=4)
    return scene, spec, eager


def test_rgb_films_replay_frames_after_the_first_unless_spans_record(card_stub):
    """On a card, frame 0 renders eagerly and every later frame replays the
    graph; while spans record, every frame renders eagerly and no graph is
    captured."""
    scene, spec, eager = card_stub
    cam = object()
    fl, ov = bdpt_rgb.render_film_frames(scene, spec, cam, film.new_film(4, 4, device=CPU),
                                         n_frames=3)
    # frame 0 eagerly, then two replays (a FakeGraph replay renders frame 1)
    assert fl.frame == 3 and ov == 0 and eager == [0, 1, 1]
    assert len(FakeGraph.made) == 1 and bdpt_rgb.sliced_frame().frame_graph.calls == 2
    eager.clear()
    with metrics.recording():
        fl, _ = bdpt_rgb.render_film_frames(scene, spec, cam, film.new_film(4, 4, device=CPU),
                                            n_frames=3)
    metrics.clear_spans()
    assert fl.frame == 3 and eager == [0, 1, 2] and len(FakeGraph.made) == 1
    assert bdpt_rgb.sliced_frame().frame_graph.calls == 2


def test_the_rgb_path_keeps_the_graph_of_its_last_inputs(card_stub):
    """One graph for the last (scene, spec, cam) and settings rendered: kept
    across calls and for an equal spec, replaced by a new camera or new
    settings."""
    scene, spec, _ = card_stub
    cam, cam2 = object(), object()

    def frames(spec, cam, **settings):
        fl = dataclasses.replace(film.new_film(4, 4, device=CPU), frame=1)
        bdpt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=1, **settings)
        return bdpt_rgb.sliced_frame(**settings).frame_graph

    g = frames(spec, cam)
    assert frames(spec, cam) is g
    assert frames(SimpleNamespace(width=4, height=4), cam) is g  # an equal spec
    g2 = frames(spec, cam2)
    assert g2 is not g and bdpt_rgb.sliced_frame().frame_graph is g2
    old = bdpt_rgb.sliced_frame()
    g3 = frames(spec, cam2, shadow_cap=0.5)
    assert g3 is not g2 and bdpt_rgb.sliced_frame(shadow_cap=0.5) is not old
    assert g3.render_frame.keywords["shadow_cap"] == 0.5
    assert frames(spec, cam2) is not g2  # only the last settings keep their graph
    assert len(FakeGraph.made) == 4


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
    graph = frame_graph.FrameGraph(render_frame, scene, spec, cam)
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
        graphed, ov = frame_graph.render_film_frames(scene, spec, cam, graphed, render_frame, 3)
        assert ov == 0
    kept = render_frame.frame_graph
    assert kept is not None
    eager = film.new_film(64, 64, seed=2147483659, device=scene.device)
    with metrics.recording():
        for _ in range(2):
            eager, _ = frame_graph.render_film_frames(scene, spec, cam, eager, render_frame, 3)
    metrics.clear_spans()
    assert render_frame.frame_graph is kept
    assert graphed.frame == eager.frame == 6
    assert torch.equal(graphed.key, eager.key)
    assert torch.equal(_bits(graphed.hdr), _bits(eager.hdr))


@pytest.fixture(scope="module")
def veach_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    scene, cfg = scenes.example_cached("veach_bdpt", dev)
    settings = dict(walk_compaction=cfg.bdpt_walk_compaction, shadow_cap=cfg.bdpt_shadow_cap)
    return scene, cfg, settings


@pytest.mark.gpu
@pytest.mark.parametrize("size", (64, 256))
def test_rgb_graph_replays_equal_eager_frames(veach_card, size):
    """Replays of one sliced RGB FrameGraph on the cluster-traced Veach
    scene under two keys and again under the first: each the eager frame
    of that key, bit for bit, overflow included (at 256^2 the walk
    wavefronts also take the tracer's sorted route)."""
    scene, cfg, settings = veach_card
    spec, cam = scenes.make_camera(scene, cfg, size, size)
    render_frame = bdpt_rgb.sliced_frame(2, **settings)
    graph = frame_graph.FrameGraph(render_frame, scene, spec, cam)
    keys = [rng.split(rng.PRNGKey(s))[0] for s in (11, 2999999929, 11)]
    for key in keys:
        img, ov = graph(key)
        img, ov = img.clone(), ov.clone()
        want, want_ov = render_frame(scene, spec, cam, 5, key, return_overflow=True)
        assert torch.equal(_bits(img), _bits(want)) and int(ov) == int(want_ov)


@pytest.mark.gpu
def test_rgb_graphed_film_equals_the_recorded_eager_film(veach_card):
    """bdpt_rgb.render_film_frames replays the graph unless spans record:
    the two films are equal bit for bit, one graph is captured and kept
    across calls, and every frame of index > 0 is one replay of it."""
    scene, cfg, settings = veach_card
    spec, cam = scenes.make_camera(scene, cfg, 64, 64)
    bdpt_rgb.sliced_frame(2, **settings).frame_graph = None
    captures, replays = frame_graph.FrameGraph.captures, frame_graph.FrameGraph.replays
    graphed = film.new_film(64, 64, seed=2147483659, device=scene.device)
    for _ in range(2):
        graphed, ov = bdpt_rgb.render_film_frames(scene, spec, cam, graphed, 3, 2, **settings)
        assert ov == 0
    kept = bdpt_rgb.sliced_frame(2, **settings).frame_graph
    assert kept is not None
    assert frame_graph.FrameGraph.captures - captures == 1
    assert frame_graph.FrameGraph.replays - replays == 5
    eager = film.new_film(64, 64, seed=2147483659, device=scene.device)
    with metrics.recording():
        for _ in range(2):
            eager, _ = bdpt_rgb.render_film_frames(scene, spec, cam, eager, 3, 2, **settings)
    metrics.clear_spans()
    assert bdpt_rgb.sliced_frame(2, **settings).frame_graph is kept
    assert frame_graph.FrameGraph.captures - captures == 1
    assert frame_graph.FrameGraph.replays - replays == 5
    assert graphed.frame == eager.frame == 6
    assert torch.equal(graphed.key, eager.key)
    assert torch.equal(_bits(graphed.hdr), _bits(eager.hdr))
