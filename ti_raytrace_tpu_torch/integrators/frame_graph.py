"""A BDPT frame replayed from one CUDA graph, for both BDPT integrators.

A frame function f(scene, spec, cam, frame, key, return_overflow=True) ->
(img, overflow) that reads no host value inside the frame can be captured
into a CUDA graph: the RGB frame (`bdpt_rgb.sliced_frame`, render_frame_sliced
bound to its settings) and the spectral one (`bdpt_spec.make_render_frame`'s).
`render_film_frames` renders a film with either: on a card, every frame of
index > 0 replays the frame function's graph of the (scene, spec, cam) it
renders, except while spans record (metrics.recording_now), when every
frame runs eagerly and records its spans.  Frame 0 renders without the
camera jitter, so it always runs eagerly.  The film's running mean and
the overflow sum stay outside the graph.
"""

import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.camera import CameraSpec
from ti_raytrace_tpu_torch.core import rng


class FrameGraph:
    """The frame of `render_frame` on one scene, camera spec and camera,
    captured into a CUDA graph and replayed: one graph launch and two key
    writes a frame in place of the tens of thousands of torch calls the host
    would issue, so the card, not the host, sets the pace.  The capture
    draws through a DeviceKey, whose words each call writes, and renders a
    frame of index > 0 (the camera jitter is on).  A replay runs the kernels
    the eager frame launches, with the same arguments: the same bits.  The
    outputs are the graph's own tensors, overwritten by the next replay.

    `captures` and `replays` count the graphs captured and the frames
    replayed by every FrameGraph, as plain host integers (no torch call)."""

    captures = 0
    replays = 0

    def __init__(self, render_frame, scene, spec: CameraSpec, cam):
        dev = scene.device
        self.inputs = (scene, spec, cam)
        self.words = torch.zeros(2, dtype=torch.int64, device=dev)
        key = rng.DeviceKey(self.words)
        # torch's rule for a capture: one run first, on a side stream
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            render_frame(scene, spec, cam, 1, key, return_overflow=True)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.img, self.overflow = render_frame(scene, spec, cam, 1, key,
                                                   return_overflow=True)
        FrameGraph.captures += 1

    def renders(self, scene, spec: CameraSpec, cam) -> bool:
        return self.inputs[0] is scene and self.inputs[1] == spec and self.inputs[2] is cam

    def __call__(self, key):
        """(img, overflow) of the frame of host key `key` (index > 0)."""
        k1, k2 = key.tolist()
        self.words[0].fill_(k1)  # a fill launch each: no host-to-device copy
        self.words[1].fill_(k2)
        self.graph.replay()
        FrameGraph.replays += 1
        return self.img, self.overflow


def graph_of(render_frame, scene, spec: CameraSpec, cam) -> FrameGraph:
    """The frame function's FrameGraph of these inputs, captured at first
    use; a frame function keeps the graph of the inputs it rendered last,
    as its attribute `frame_graph`."""
    graph = getattr(render_frame, "frame_graph", None)
    if graph is None or not graph.renders(scene, spec, cam):
        render_frame.frame_graph = None  # the old graph's memory goes first
        graph = render_frame.frame_graph = FrameGraph(render_frame, scene, spec, cam)
    return graph


def render_film_frames(scene, spec: CameraSpec, cam, film, render_frame, n_frames: int = 4):
    """n progressive frames by the frame function `render_frame`, each from
    the film's frame index and key, then accumulated.  Returns (film',
    overflow as an int: one host sync, the span `sync.overflow`).  On a
    card, frames of index > 0 replay the frame function's FrameGraph,
    except while spans record, when every frame runs eagerly."""
    from ti_raytrace_tpu_torch import film as film_mod

    graphed = scene.device.type == "cuda" and not metrics.recording_now()
    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames):
        if graphed and film.frame != 0:
            img, ov = graph_of(render_frame, scene, spec, cam)(film.key)
        else:
            img, ov = render_frame(scene, spec, cam, film.frame, film.key,
                                   return_overflow=True)
        with metrics.span("film.accumulate"):
            film = film_mod.accumulate(film, img)
            total = total + ov
    with metrics.span("sync.overflow"):
        return film, int(total)
