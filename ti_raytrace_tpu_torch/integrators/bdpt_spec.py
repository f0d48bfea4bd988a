"""Spectral bidirectional path tracer, one stochastic wavelength per lane
(twin of ti_raytrace_tpu/integrators/bdpt_spec.py).

The BDPT machinery of bdpt_rgb.py runs with a scalar per-lane `power`
throughput at one wavelength per frame (lambda uniform over the sensor
range), dispersive BK7 glass, light and reflectance power from the packed
rgb2spec coefficients and D65, and a CIE-sensor conversion to sRGB at the
splat and at the end of the frame (rgb clamped to [0, 1000] and scaled by
the sensor span, the Monte Carlo normalisation of pdf(lambda) = 1/span).
It renders the prism dispersion demo.

Differences from the reference, by design: the per-lane table lookups
are a bin index and column gathers (the reference writes them as one-hot
matmuls at its highest precision; a gather is exact and no matmul that
TF32 could reach on the card), and XYZ -> sRGB is nine multiply-adds in
the matrix product's order.  As in the port's bdpt_rgb, the render
returns its overflow (walk compaction plus capped shadow lanes) with
`return_overflow`, and there is no jit: on a card, `render_film_frames`
replays frames of index > 0 from one CUDA graph of the frame
(`FrameGraph`) instead.
"""

from typing import NamedTuple

import numpy as np
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.camera import CameraSpec
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import bdpt_rgb
from ti_raytrace_tpu_torch.spectral.rgb2spec import eval_hero


class SpecCtx(NamedTuple):
    """One frame's single-wavelength spectral context of the BDPT walks."""
    lam: torch.Tensor         # (N,) wavelength per lane
    d65_val: torch.Tensor     # (N,) normalized D65 at lam (times the emitter scale)
    sensor_rgb: torch.Tensor  # (3, N) clamp(M @ cie(lam), 0, 1000) * span

    def reflect_power(self, attr):
        """Reflectance at lam from the packed rgb2spec coefficient rows
        (scene/packs.py 32:35); (1, N)."""
        return eval_hero(attr[32], attr[33], attr[34], self.lam)[None]

    def light_power_attr(self, attr):
        """Emission power at lam from the packed emission-tint rows 35:39
        (d65 * tint spectrum * |emission|); (1, N)."""
        s = eval_hero(attr[35], attr[36], attr[37], self.lam)
        return (self.d65_val * s * attr[38])[None]

    def light_power_sample(self, ls):
        """The same from a light-sample dict (scene/sample_planar.py),
        times the sample's visibility where it carries one."""
        s = eval_hero(ls["em_c0"], ls["em_c1"], ls["em_c2"], self.lam)
        p = self.d65_val * s * ls["em_scale"]
        vis = ls.get("vis")
        if vis is not None:
            p = p * vis
        return p[None]

    def to_rgb(self, power):
        """Scalar spectral radiance (1, N) or (3, N) -> linear sRGB (3, N)
        through the per-lane CIE sensor response."""
        return self.sensor_rgb * power


def make_spec_ctx_fn(emitter_scale: float = 1.0, device="cuda"):
    """Closes over the sensor and D65 tables on `device`; returns
    f(key, N) -> SpecCtx drawing one wavelength per lane, inside the span
    `bdpt.spec_ctx` (attribute `width`, N).

    emitter_scale: per-scene factor on every emission term, folded into
    the D65 table, which feeds only light_power_attr / light_power_sample
    (sqrt(3) for the prism: the lamp scale its golden embodies, PARITY.md
    'spectral emitter scale'; 1 is the physically consistent estimator)."""
    from ti_raytrace_tpu_torch.spectral.cie import load_cie_sensor, normalized_d65

    sensor = load_cie_sensor()
    lam_min = sensor.lambda_min
    span = sensor.lambda_max - sensor.lambda_min
    NB = len(sensor.lambdas)
    cie = torch.as_tensor(np.asarray(sensor.xyz.T, np.float32), device=device)  # (3, NB)
    d65 = normalized_d65(sensor)
    d65_tab = torch.as_tensor(
        np.asarray(d65.sample(sensor.lambdas), np.float32) * np.float32(emitter_scale),
        device=device)  # (NB,)
    m = [[float(v) for v in row] for row in np.asarray(C.XYZ_TO_SRGB, np.float32)]

    def spec_ctx(key, N):
        with metrics.span("bdpt.spec_ctx", width=N):
            u = rng.uniform(key, (N,), device=device)
            lam = lam_min + u * span
            bins = torch.clamp((u * NB).to(torch.int32), max=NB - 1).long()
            xyz = cie.index_select(1, bins)  # (3, N)
            rgb = torch.stack([m[r][0] * xyz[0] + m[r][1] * xyz[1] + m[r][2] * xyz[2]
                               for r in range(3)])
            rgb = torch.clamp(rgb, 0.0, 1000.0) * span
            return SpecCtx(lam=lam, d65_val=d65_tab.index_select(0, bins), sensor_rgb=rgb)

    return spec_ctx


def make_render_frame(emitter_scale: float = 1.0, walk_compaction=None, shadow_cap=None,
                      device="cuda"):
    """A render_frame(scene, spec, cam, frame, key[, return_overflow]) ->
    (W, H, 3) radiance of one unsliced spectral BDPT frame, closing over
    the tables on `device` (the scene's device).  The key chain is the
    reference's: split(key) -> the wavelength key, the path key."""
    spec_ctx = make_spec_ctx_fn(emitter_scale, device)

    def render_frame(scene, spec: CameraSpec, cam, frame, key, return_overflow: bool = False):
        k_lam, k_path = rng.split(key)
        ctx = spec_ctx(k_lam, spec.width * spec.height)
        return bdpt_rgb.render_paths(scene, spec, cam, frame, k_path, spec_ctx=ctx,
                                     walk_compaction=walk_compaction, shadow_cap=shadow_cap,
                                     return_overflow=return_overflow)

    return render_frame


class FrameGraph:
    """The spectral BDPT frame of `render_frame` (make_render_frame's) on
    one scene, camera spec and camera, captured into a CUDA graph and
    replayed: one graph launch and two key writes a frame in place of the
    ~18,500 torch calls the host would issue, so the card, not the host,
    sets the pace.  The capture draws through a DeviceKey, whose words each
    call writes, and renders a frame of index > 0 (the camera jitter is
    on; frame 0 renders without it, so it stays outside the graph).  A
    replay runs the kernels the eager frame launches, with the same
    arguments: the same bits.  The outputs are the graph's own tensors,
    overwritten by the next replay."""

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

    def renders(self, scene, spec: CameraSpec, cam) -> bool:
        return self.inputs[0] is scene and self.inputs[1] == spec and self.inputs[2] is cam

    def __call__(self, key):
        """(img, overflow) of the frame of host key `key` (index > 0)."""
        k1, k2 = key.tolist()
        self.words[0].fill_(k1)  # a fill launch each: no host-to-device copy
        self.words[1].fill_(k2)
        self.graph.replay()
        return self.img, self.overflow


def _frame_graph(render_frame, scene, spec: CameraSpec, cam) -> FrameGraph:
    """The renderer's FrameGraph of these inputs, captured at first use;
    a renderer keeps the graph of the inputs it rendered last."""
    graph = getattr(render_frame, "frame_graph", None)
    if graph is None or not graph.renders(scene, spec, cam):
        render_frame.frame_graph = None  # the old graph's memory goes first
        graph = render_frame.frame_graph = FrameGraph(render_frame, scene, spec, cam)
    return graph


def render_film_frames(scene, spec: CameraSpec, cam, film, render_frame, n_frames: int = 4):
    """n progressive frames by `render_frame` (make_render_frame's), each
    from the film's frame index and key, then accumulated.  Returns
    (film', overflow as an int: one host sync, the span `sync.overflow`).
    On a card, frames of index > 0 replay the renderer's FrameGraph,
    except while spans record (metrics.recording_now), when every frame
    runs eagerly and records its spans."""
    from ti_raytrace_tpu_torch import film as film_mod

    graphed = scene.device.type == "cuda" and not metrics.recording_now()
    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames):
        if graphed and film.frame != 0:
            img, ov = _frame_graph(render_frame, scene, spec, cam)(film.key)
        else:
            img, ov = render_frame(scene, spec, cam, film.frame, film.key,
                                   return_overflow=True)
        with metrics.span("film.accumulate"):
            film = film_mod.accumulate(film, img)
            total = total + ov
    with metrics.span("sync.overflow"):
        return film, int(total)
