"""Hero-wavelength spectral path tracer, wavefront and planar (twin of
ti_raytrace_tpu/integrators/pt_spec.py).

Per pixel and frame one hero wavelength lambda0 in [360, 460) carries 4
correlated wavelengths (lambda0 + i * 100 nm); the 4-vector throughput
rides the wavefront machinery of pt_rgb.  Spectral data is tabulated on
the host into hero matrices (spectral/spd.py) and per-material rgb2spec
coefficients (scene/packs.py rows 32:40); a lane reads its column by an
index gather.

Quirks of the reference kept for golden parity (PARITY.md):
  * emitter hits always count in full (the reference's emitter-hit MIS
    weight is dead code) and only register from the front side
    (direction . normal < 0);
  * at glass, dispersion picks one of the 4 hero wavelengths for the
    refracted direction, and the full 4-vector throughput continues;
  * no Beer-Lambert roulette (unlike pt_rgb);
  * misses shade the Hosek-Wilkie sky scaled by the D65 light spectrum;
  * the emission tint is saturated to 1 (emission spectrum = D65 *
    |emission_rgb|_2), NEE is tinted by the sampled light's emission and
    weighted with the power heuristic, and every emitter term is scaled
    by the scene's `emitter_scale` (sqrt(3) for the spectral box).
The reference's diagnostic switches around these stay behind.

Differences from the reference, by design, as in the port's pt_rgb: the
carry is a dict whose pixel ids and hero bins are int64 tensors (the
reference packs the carry into one float matrix for XLA's while loop);
`_while_bounces_spec` checks for live lanes on the host once per bounce;
overflow counts stay on the device until the end of a render call; XYZ
-> sRGB is nine multiply-adds (no matmul that TF32 could reach on the
card).

MAX_DEPTH = 10, the reference's.
"""

from typing import NamedTuple

import torch

from ti_raytrace_tpu_torch import film as film_mod
from ti_raytrace_tpu_torch.accel import trace, trace_shaded
from ti_raytrace_tpu_torch.bsdf.planar import disney_evaluate_pdf, disney_sample, glass_sample
from ti_raytrace_tpu_torch.camera import CameraSpec, ray_directions, ray_origins
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators.pt_rgb import _compact, _phase_width
from ti_raytrace_tpu_torch.ops import planar as pv
from ti_raytrace_tpu_torch.ops.shading import decode_hit
from ti_raytrace_tpu_torch.scene.sample_planar import sample_li
from ti_raytrace_tpu_torch.sky.hosek import sky_radiance_hero
from ti_raytrace_tpu_torch.spectral import spd as spd_mod
from ti_raytrace_tpu_torch.spectral.rgb2spec import eval_hero
from ti_raytrace_tpu_torch.utils.geometry import bk7_ior
from ti_raytrace_tpu_torch.utils.sampling import power_heuristic

MAX_DEPTH = 10


class SpectralData(NamedTuple):
    """Spectral tables on one device, all in hero-matrix form (R, HERO_BINS)."""
    d65_hero: torch.Tensor       # (4, NB) normalised D65 (Y-white = 1)
    cie_hero: torch.Tensor       # (12, NB): x(4), y(4), z(4) rows
    spd_hero: torch.Tensor       # (12, NB): white(4), red(4), green(4)
    sky_configs: torch.Tensor    # (11, 9)
    sky_radiances: torch.Tensor  # (11,)
    sun_dir: torch.Tensor        # (3,)
    cie_span: float              # sensor lambda_max - lambda_min
    emitter_scale: float         # golden-parity lamp scale


def make_spectral_data(turbidity=3.0, albedo=0.5, elevation=0.17,
                       emitter_scale=1.0, device="cuda") -> SpectralData:
    """Host precompute of the tables, moved to `device`.  The sky defaults
    are the reference integrator's.  emitter_scale: per-scene factor on
    every emitter term (emitter hits and NEE); the spectral box passes
    sqrt(3), the lamp scale its golden embodies (PARITY.md 'spectral
    emitter scale')."""
    import numpy as np

    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.sky.hosek import build_sky
    from ti_raytrace_tpu_torch.spectral.cie import load_cie_sensor, normalized_d65
    from ti_raytrace_tpu_torch.spectral.spd import hero_matrix, load_spd_csv

    sensor = load_cie_sensor()
    d65 = normalized_d65(sensor)
    cie = np.concatenate(
        [hero_matrix(lambda lam, k=k: sensor.sample(lam)[..., k]) for k in range(3)], axis=0)
    spds = np.concatenate(
        [hero_matrix(load_spd_csv(asset_path(f"spectrum/{name}-spec.csv")).sample)
         for name in ("white", "red", "green")], axis=0)
    sky = build_sky(turbidity, albedo, elevation)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SpectralData(
        d65_hero=f32(hero_matrix(d65.sample)),
        cie_hero=f32(cie),
        spd_hero=f32(spds),
        sky_configs=f32(sky.configs),
        sky_radiances=f32(sky.radiances),
        sun_dir=f32(sky.sun_dir),
        cie_span=float(sensor.lambda_max - sensor.lambda_min),
        emitter_scale=float(emitter_scale),
    )


def _hero_lambdas(lam0):
    """(4, N) hero wavelengths of the carried lambda0 row."""
    steps = torch.arange(4, dtype=torch.float32, device=lam0.device)[:, None]
    return lam0[None, :] + steps * spd_mod.LAMBDA_STEP


def _bounce(scene, sdata, carry, key):
    """One bounce: trace the carry's rays and shade the hits.  Uniform
    rows 0:3 NEE, 3:6 BSDF, 6 the hero wavelength that refracts."""
    o = carry["origin"]
    d = carry["direction"]
    alive = carry["alive"]
    lam4 = _hero_lambdas(carry["lam0"])
    light_rad = carry["light_rad"]  # (4, N) D65 at the hero wavelengths
    spd_vals = carry["spd_vals"]    # (12, N) measured SPDs at the hero wavelengths
    N = o.shape[1]

    u = rng.uniform(key, (8, N), device=o.device)
    u_nee = u[0:3]
    u_bsdf = u[3:6]
    u_hero = u[6]

    t, prim, uv_bary, attr = trace_shaded(scene, o, d)
    hit = decode_hit(o, d, t, prim, uv_bary, attr)
    valid = hit.valid & alive
    fnormal = pv.faceforward(hit.normal, -d, hit.gnormal)

    throughput = carry["throughput"]  # (4, N)
    radiance = carry["radiance"]      # (4, N)

    # per-hit spectral quantities from the packed attribute rows
    refl_spec_rgb = eval_hero(attr[32][None], attr[33][None], attr[34][None], lam4)
    em_tint = attr[38][None].expand(4, N)  # the saturated tint: 1 * |emission|
    spd_id = attr[39]
    measured = torch.where(
        (spd_id == 0.0)[None], spd_vals[0:4],
        torch.where((spd_id == 1.0)[None], spd_vals[4:8], spd_vals[8:12]))
    reflect_spec = torch.where((spd_id >= 0.0)[None], measured, refl_spec_rgb)

    # miss: defer the sky lookup; record direction + weight
    miss = alive & ~hit.valid
    carry_miss_dir = pv.where(miss, d, carry["miss_dir"])
    carry_miss_w = torch.where(miss[None], throughput * light_rad, carry["miss_weight"])

    # emitter hit: full contribution, front side only
    fcos = pv.dot(d, hit.normal)
    is_light = valid & (hit.mat_type == C.MAT_LIGHT) & (fcos < 0.0)
    em_scale = sdata.emitter_scale
    radiance = radiance + em_scale * torch.where(
        is_light[None], throughput * light_rad * em_tint, 0.0)

    # glass: dispersive delta bounce; one hero wavelength picks the direction
    is_glass = valid & (hit.mat_type == C.MAT_GLASS)
    hero_idx = torch.clamp((u_hero * 4).to(torch.int32), max=3)  # truncate, then clamp
    lam_rnd = lam4[0] + hero_idx.to(torch.float32) * spd_mod.LAMBDA_STEP
    g_dir, g_forb = glass_sample(u_bsdf[0], d, hit.normal, bk7_ior(lam_rnd))

    # disney: NEE + continuation
    is_disney = valid & (hit.mat_type != C.MAT_GLASS) & (hit.mat_type != C.MAT_LIGHT)
    ls = sample_li(scene, hit.pos, u_nee)
    ndl_surf = pv.dot(fnormal, ls["direction"])
    ndl_light = pv.dot(ls["normal"], ls["direction"])
    nee_geo_ok = is_disney & (ndl_surf < 0.0) & (ndl_light > 0.0)
    # the shadow ray starts just off the sampled emitter point and must hit
    # this lane's own prim first; lanes without a Disney hit are parked
    sh_o = pv.where(is_disney, pv.offset_ray(ls["pos"], ls["normal"]),
                    torch.full_like(ls["pos"], 1e9))
    _, sh_prim = trace(scene, sh_o, ls["direction"])
    unoccluded = sh_prim == prim
    nee_brdf, nee_pdf = disney_evaluate_pdf(fnormal, -d, -ls["direction"],
                                            hit.mat_p0, hit.mat_p1)
    nee_em_tint = (ls["em_scale"] * ls["vis"])[None].expand(4, N)
    light_pdf = (ls["dist"] * ls["dist"] * ls["choice_pdf"]
                 / torch.clamp(ndl_light, min=1e-12))
    nee_ok = nee_geo_ok & unoccluded & (nee_pdf > 0.0)
    nee_w = (power_heuristic(light_pdf, nee_pdf) / torch.clamp(light_pdf, min=1e-4)
             * nee_brdf * torch.abs(ndl_surf))
    radiance = radiance + em_scale * torch.where(
        nee_ok[None], nee_w[None] * light_rad * nee_em_tint * throughput * reflect_spec, 0.0)

    d_dir = disney_sample(u_bsdf, d, fnormal, hit.mat_p0, hit.mat_p1)
    d_brdf, d_pdf = disney_evaluate_pdf(fnormal, -d, d_dir, hit.mat_p0, hit.mat_p1)
    d_brdf = d_brdf * torch.abs(pv.dot(hit.normal, d_dir))

    next_dir = pv.where(is_glass, g_dir, d_dir)
    f_or_b = torch.where(is_glass, g_forb, 1.0)
    brdf = torch.where(is_glass, 1.0, d_brdf)
    brdf_pdf = torch.where(is_glass, 1.0, d_pdf)
    next_origin = pv.offset_ray(hit.pos, fnormal * pv.sign_nonzero(f_or_b)[None])

    cont = ((is_glass | is_disney) & (brdf_pdf > 0.0)
            & (throughput.amax(dim=0) > 0.0))
    throughput = torch.where(
        cont[None],
        throughput * reflect_spec * (brdf / torch.clamp(brdf_pdf, min=1e-12))[None],
        throughput,
    )
    return dict(
        origin=pv.where(cont, next_origin, torch.full_like(o, 1e9)),
        direction=pv.where(cont, next_dir, d),
        throughput=throughput,
        radiance=radiance,
        alive=cont,
        lam0=carry["lam0"],
        bin=carry["bin"],
        light_rad=light_rad,
        spd_vals=spd_vals,
        miss_dir=carry_miss_dir,
        miss_weight=carry_miss_w,
        pixel=carry["pixel"],
    )


def _new_carry_spec(sdata: SpectralData, o, d, key):
    """Fresh camera wavefront: the hero wavelength of each lane and the
    per-lane table columns."""
    N = o.shape[1]
    dev = o.device
    u_lam = rng.uniform(key, (N,), device=dev)
    bins = spd_mod.hero_bin(u_lam)
    return dict(
        origin=o,
        direction=d,
        throughput=torch.ones((4, N), dtype=torch.float32, device=dev),
        radiance=torch.zeros((4, N), dtype=torch.float32, device=dev),
        alive=torch.ones((N,), dtype=torch.bool, device=dev),
        lam0=spd_mod.LAMBDA_MIN + u_lam * spd_mod.LAMBDA_STEP,
        bin=bins,
        light_rad=spd_mod.hero_select(sdata.d65_hero, bins),
        spd_vals=spd_mod.hero_select(sdata.spd_hero, bins),
        miss_dir=torch.zeros((3, N), dtype=torch.float32, device=dev),
        miss_weight=torch.zeros((4, N), dtype=torch.float32, device=dev),
        pixel=torch.arange(N, dtype=torch.int64, device=dev),
    )


def _flush_spec(sdata: SpectralData, carry, accum, identity: bool = False):
    """Bank the carry's spectral radiance into the full-width XYZ accum
    (3, N0) by pixel id, resolving the pending sky misses in the same
    pass, and clear radiance, miss_dir and miss_weight in the carry.  The
    hero radiance converts to XYZ here (the conversion is linear, so
    partial flushes sum to the unflushed result) through the lane's CIE
    response columns, read by its hero bin.  identity=True: the carry was
    never compacted (pixel == arange), so a plain add."""
    lam4 = _hero_lambdas(carry["lam0"])

    # deferred sky of the lanes that escaped during this phase
    md = carry["miss_dir"]
    missed = (carry["miss_weight"] != 0.0).any(dim=0)
    dis = torch.sqrt(md[0] * md[0] + md[2] * md[2])
    beta = torch.atan2(md[1], dis)
    sun = sdata.sun_dir
    cosg = torch.clamp(md[0] * sun[0] + md[1] * sun[1] + md[2] * sun[2], -1.0, 1.0)
    gamma = torch.acos(cosg)
    theta = torch.clamp(0.5 * C.PI - beta, 0.0, 0.5 * C.PI)
    sky_spec = sky_radiance_hero(sdata.sky_configs, sdata.sky_radiances, theta, gamma, lam4)
    radiance = carry["radiance"] + torch.where(
        missed[None], sky_spec * carry["miss_weight"], 0.0)

    cie_vals = spd_mod.hero_select(sdata.cie_hero, carry["bin"])  # (12, n)
    span = sdata.cie_span / 4.0
    w = [cie_vals[4 * k:4 * k + 4] * radiance for k in range(3)]
    xyz = torch.stack([(((r[0] + r[1]) + r[2]) + r[3]) * span for r in w])  # (3, n)

    if identity:
        accum = accum + xyz
    else:
        accum = accum.index_add(1, carry["pixel"], xyz)
    carry = dict(carry)
    for k in ("radiance", "miss_dir", "miss_weight"):
        carry[k] = torch.zeros_like(carry[k])
    return carry, accum


# alive-first stable order + the first new_n lanes; (carry', live lanes
# killed): pt_rgb's compaction serves the spectral carry as it is
_compact_spec = _compact


def _while_bounces_spec(scene, sdata, carry, key, depth0: int, b1: int):
    """Bounces [depth0, b1), stopping early once no lane is alive (one
    host check per bounce)."""
    depth = depth0
    while depth < b1 and bool(carry["alive"].any()):
        carry = _bounce(scene, sdata, carry, rng.fold_in(key, depth))
        depth += 1
    return carry


def _xyz_to_srgb(xyz):
    """(3, N) XYZ -> linear sRGB, as nine multiply-adds."""
    m = C.XYZ_TO_SRGB
    return torch.stack([
        float(m[r, 0]) * xyz[0] + float(m[r, 1]) * xyz[1] + float(m[r, 2]) * xyz[2]
        for r in range(3)])


def trace_paths_spec(scene, sdata: SpectralData, o, d, key, max_depth: int = MAX_DEPTH,
                     compaction=None, return_overflow: bool = False):
    """Spectral path trace of a planar wavefront -> linear sRGB (3, N)
    (and the overflow kill count, a device scalar, with return_overflow).

    compaction: ((start_bounce, shrink_divisor), ...), the contract of
    pt_rgb.trace_paths: after `start_bounce` bounces the wavefront
    flushes its radiance (an XYZ scatter by pixel id) and shrinks to
    N / divisor lanes; live lanes beyond that capacity are killed and
    counted (0 kills: the exact estimator)."""
    compaction = tuple(compaction or ())
    N = o.shape[1]
    k_lam, k_path = rng.split(key)
    carry = _new_carry_spec(sdata, o, d, k_lam)
    accum = torch.zeros((3, N), dtype=torch.float32, device=o.device)  # XYZ by pixel
    overflow = torch.zeros((), dtype=torch.int64, device=o.device)

    starts = [0] + [s for s, _ in compaction]
    ends = [s for s, _ in compaction] + [max_depth]
    widths = [N] + [_phase_width(N, dv) for _, dv in compaction]
    for phase, (b0, b1, width) in enumerate(zip(starts, ends, widths)):
        if b0 >= max_depth:
            break
        if phase > 0:
            carry, accum = _flush_spec(sdata, carry, accum, identity=(phase == 1))
            carry, ov = _compact_spec(carry, width)
            overflow = overflow + ov
        carry = _while_bounces_spec(scene, sdata, carry, k_path, b0, min(b1, max_depth))

    carry, accum = _flush_spec(sdata, carry, accum, identity=(not compaction))
    rgb = _xyz_to_srgb(accum)
    if return_overflow:
        return rgb, overflow
    return rgb


def _render(scene, sdata, spec, cam, frame: int, key, compaction, max_depth):
    """One frame from the film's key: ((W, H, 3) linear sRGB, overflow)."""
    k_cam, k_path = rng.split(key)
    o = ray_origins(spec, cam).T.contiguous()
    d = ray_directions(spec, cam, frame, k_cam).T.contiguous()
    rgb, ov = trace_paths_spec(scene, sdata, o, d, k_path, compaction=compaction,
                               return_overflow=True, max_depth=max_depth)
    return rgb.T.reshape(spec.width, spec.height, 3), ov


def render_film_frames_spec(scene, sdata: SpectralData, spec: CameraSpec, cam, film,
                            n_frames: int = 4, compaction=None,
                            max_depth: int = MAX_DEPTH):
    """n spectral frames accumulated into the film, one after the other,
    on the key and frame discipline of the single-frame loop
    (render(film.frame, film.key), then film.accumulate).  Returns
    (film', overflow kills as an int)."""
    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames):
        img, ov = _render(scene, sdata, spec, cam, film.frame, film.key, compaction,
                          max_depth)
        film = film_mod.accumulate(film, img)
        total = total + ov
    return film, int(total)


def make_render_frame(turbidity=3.0, albedo=0.5, elevation=0.17, emitter_scale=1.0,
                      compaction=None, max_depth: int = MAX_DEPTH, device="cuda"):
    """A render_frame(scene, spec, cam, frame, key) -> (W, H, 3) closing
    over the spectral tables on `device` (the scene's device)."""
    sdata = make_spectral_data(turbidity, albedo, elevation, emitter_scale, device=device)

    def render_frame(scene, spec: CameraSpec, cam, frame: int, key):
        return _render(scene, sdata, spec, cam, frame, key, compaction, max_depth)[0]

    return render_frame
