"""Spectral bidirectional path tracer, one stochastic wavelength per lane
(the port's integrators/bdpt_spec.py as the benchmark froze it, with the
unsliced frame of its bdpt_rgb.render_paths, which the frozen bdpt_rgb
lacks, cut to the reference's estimator).

The BDPT machinery of bdpt_rgb.py runs with a scalar per-lane `power`
throughput at one wavelength per frame (lambda uniform over the sensor
range), dispersive BK7 glass, light and reflectance power from the packed
rgb2spec coefficients and D65, and a CIE-sensor conversion to sRGB at the
splat and at the end of the frame (rgb clamped to [0, 1000] and scaled by
the sensor span, the Monte Carlo normalisation of pdf(lambda) = 1/span).
It renders the prism dispersion demo.

The per-lane table lookups are a bin index and column gathers, and
XYZ -> sRGB is nine multiply-adds in the matrix product's order.  The
render returns its overflow (walk compaction plus capped shadow lanes)
with `return_overflow`.
"""

from typing import NamedTuple

import numpy as np
import torch

from reference.plain.camera import CameraSpec
from reference.plain.core import rng
from reference.plain.integrators import bdpt_rgb
from reference.plain.spectral.rgb2spec import eval_hero


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
    f(key, N) -> SpecCtx drawing one wavelength per lane.  emitter_scale:
    per-scene factor on every emission term, folded into the D65 table."""
    from reference.plain.spectral.cie import XYZ_TO_SRGB, load_cie_sensor, normalized_d65

    sensor = load_cie_sensor()
    lam_min = sensor.lambda_min
    span = sensor.lambda_max - sensor.lambda_min
    NB = len(sensor.lambdas)
    cie = torch.as_tensor(np.asarray(sensor.xyz.T, np.float32), device=device)  # (3, NB)
    d65 = normalized_d65(sensor)
    d65_tab = torch.as_tensor(
        np.asarray(d65.sample(sensor.lambdas), np.float32) * np.float32(emitter_scale),
        device=device)  # (NB,)
    m = [[float(v) for v in row] for row in np.asarray(XYZ_TO_SRGB, np.float32)]

    def spec_ctx(key, N):
        u = rng.uniform(key, (N,), device=device)
        lam = lam_min + u * span
        bins = torch.clamp((u * NB).to(torch.int32), max=NB - 1).long()
        xyz = cie.index_select(1, bins)  # (3, N)
        rgb = torch.stack([m[r][0] * xyz[0] + m[r][1] * xyz[1] + m[r][2] * xyz[2]
                           for r in range(3)])
        rgb = torch.clamp(rgb, 0.0, 1000.0) * span
        return SpecCtx(lam=lam, d65_val=d65_tab.index_select(0, bins), sensor_rgb=rgb)

    return spec_ctx


def render_paths(scene, spec: CameraSpec, cam, frame, key, spec_ctx,
                 max_depth: int = bdpt_rgb.MAX_DEPTH, walk_compaction=None, shadow_cap=None):
    """One unsliced frame's subpaths + connections at the frame's spectral
    context -> ((W, H, 3) radiance, overflow as a device scalar): the
    port's bdpt_rgb.render_paths with the reference's estimator."""
    k_eye, k_light, k_conn = rng.split(key, 3)
    k_cam, k_ewalk = rng.split(k_eye)
    o, d = bdpt_rgb._camera_rays(spec, cam, frame, k_cam)
    eye, eye_count, light, light_count, overflow = bdpt_rgb.build_subpaths(
        scene, o, d, k_ewalk, k_light, eye_depth=max_depth + 2, light_depth=max_depth + 1,
        walk_compaction=walk_compaction, return_overflow=True, spec_ctx=spec_ctx)
    radiance, splat, kills = bdpt_rgb._connections(
        scene, spec, cam, eye, eye_count, light, light_count, k_conn, max_depth=max_depth,
        shadow_cap=shadow_cap, spec_ctx=spec_ctx)
    radiance = spec_ctx.to_rgb(radiance)
    img = radiance.T.reshape(spec.width, spec.height, 3) + splat
    return img, overflow + kills


def make_render_frame(emitter_scale: float = 1.0, walk_compaction=None, shadow_cap=None,
                      device="cuda"):
    """A render_frame(scene, spec, cam, frame, key) -> ((W, H, 3) radiance,
    overflow) of one unsliced spectral BDPT frame, closing over the tables
    on `device`.  The key chain is the reference's: split(key) -> the
    wavelength key, the path key."""
    spec_ctx = make_spec_ctx_fn(emitter_scale, device)

    def render_frame(scene, spec: CameraSpec, cam, frame, key):
        k_lam, k_path = rng.split(key)
        ctx = spec_ctx(k_lam, spec.width * spec.height)
        return render_paths(scene, spec, cam, frame, k_path, ctx,
                            walk_compaction=walk_compaction, shadow_cap=shadow_cap)

    return render_frame


def render_film_frames(scene, spec: CameraSpec, cam, film, render_frame, n_frames: int = 4):
    """n progressive frames by `render_frame` (make_render_frame's), each
    from the film's frame index and key, then accumulated.  Returns
    (film', overflow as an int)."""
    from reference.plain import film as film_mod

    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames):
        img, ov = render_frame(scene, spec, cam, film.frame, film.key)
        film = film_mod.accumulate(film, img)
        total = total + ov
    return film, int(total)
