"""Wavefront RGB path tracer, the production `nee=False` path (twin of
ti_raytrace_tpu/integrators/pt_rgb.py).

The whole film advances one bounce at a time as a planar wavefront: per
lane alive masks replace `break`, the material branches are computed
masked, and environment misses are deferred (each lane records its miss
direction and weight; the env lookup runs at flush time).  Compaction
schedules shrink the wavefront to its live lanes between phases; merged
rendering (`render_film_frames_merged`) concatenates the compacted deep
phases of `group` frames into one wavefront.

RNG: film key -> split -> (camera key, path key); bounce b draws
uniform(fold_in(path key, b), (8, N)) — bit-equal to the reference
through core/rng, so renders match it lane for lane up to rounding.

Differences from the reference, by design: the carry's pixel ids are an
int64 tensor (not bitcast into the float carry); `_while_bounces` checks
for live lanes on the host once per bounce (one device sync per bounce);
overflow counts stay on the device until the end of a render call.
Not ported: next-event estimation (`nee=True`, ROADMAP 'to port': NEE
with scene/sample_planar.py); the exact (uncompacted) mode and a first
compaction after bounce 1, whose un-presorted bounces need the sorted
tracer mode (ROADMAP 'to port': the cluster kernel's other modes); the
reference's measured-loss switches (PRESORT_CARRY, PRESORT_HALF,
TRACE0_COMPACT, NEE_FROM_EMITTER_PARITY).
"""

import torch

from ti_raytrace_tpu_torch import film as film_mod
from ti_raytrace_tpu_torch.accel import needs_presort, trace_shaded
from ti_raytrace_tpu_torch.bsdf.planar import disney_evaluate_pdf, disney_sample, glass_sample
from ti_raytrace_tpu_torch.camera import (CameraSpec, morton_pixel_order,
                                          ray_directions_morton)
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.ops import planar as pv
from ti_raytrace_tpu_torch.ops.shading import decode_hit
from ti_raytrace_tpu_torch.texture.texture import texture2d_packed
from ti_raytrace_tpu_torch.utils.colorsp import srgb_to_lrgb

MAX_DEPTH = 15

_NO_SORT = ("the exact (uncompacted) mode and compaction starting after "
            "bounce 1 trace un-presorted bounces: the sorted tracer mode is "
            "outside the ported slice (ROADMAP 'to port': the cluster "
            "kernel's other modes)")


def _check_path(nee: bool, compaction):
    if nee:
        raise NotImplementedError("nee=True is outside the ported slice (ROADMAP "
                                  "'to port': NEE with scene/sample_planar.py)")
    if not compaction or compaction[0][0] != 1:
        raise NotImplementedError(_NO_SORT)


# ------------------------------------------------------------------ carry

def _new_carry(o, d):
    N = o.shape[1]
    dev = o.device
    return dict(
        origin=o,
        direction=d,
        throughput=torch.ones((3, N), dtype=torch.float32, device=dev),
        radiance=torch.zeros((3, N), dtype=torch.float32, device=dev),
        alive=torch.ones((N,), dtype=torch.bool, device=dev),
        brdf_pdf=torch.ones((N,), dtype=torch.float32, device=dev),
        perfect_spec=torch.ones((N,), dtype=torch.bool, device=dev),  # camera rays
        miss_dir=torch.zeros((3, N), dtype=torch.float32, device=dev),
        miss_weight=torch.zeros((3, N), dtype=torch.float32, device=dev),
        pixel=torch.arange(N, dtype=torch.int64, device=dev),
    )


def _permute(carry, idx):
    """Gather every carry tensor's lanes at idx (lanes are the last axis)."""
    return {k: v.index_select(v.dim() - 1, idx) for k, v in carry.items()}


def _stable_order(key):
    """Stable ascending lane order of an int64 key (one torch.sort; keys
    never use the sign bit)."""
    return torch.sort(key, stable=True).indices


def _sort_carry(scene, carry):
    """Permute the carry into (alive-first, origin morton, direction
    morton) order: one stable sort of the composed 61-bit key."""
    from ti_raytrace_tpu_torch.ops.cluster_trace import _coherence_key

    key_o, key_d = _coherence_key(scene, carry["origin"], carry["direction"])
    dead = (~carry["alive"]).to(torch.int64)
    return _permute(carry, _stable_order((dead << 60) | (key_o << 30) | key_d))


# ---------------------------------------------------------------- bounce

def _bounce(scene, carry, key, presort: bool = False, shared_origin=None):
    """One bounce: trace the carry's rays and shade the hits.
    shared_origin: a pinhole camera wavefront in static morton lane order
    (coherent as it is); presort=True: sort the carry first and trace with
    a per-tile front-to-back order (the deep bounces)."""
    if presort:
        carry = _sort_carry(scene, carry)
    o = carry["origin"]
    d = carry["direction"]
    u = rng.uniform(key, (8, o.shape[1]), device=o.device)
    t, prim, uv_bary, attr = trace_shaded(scene, o, d, shared_origin=shared_origin,
                                          tile_order=presort)
    return _shade(scene, carry, u, t, prim, uv_bary, attr)


def _shade(scene, carry, u, t, prim, uv_bary, attr):
    """The post-trace half of _bounce: emitter hits, glass and Disney
    sampling, Beer-Lambert roulette and the carry update, from a hit
    record and per-lane uniforms u (8, N)."""
    o = carry["origin"]
    d = carry["direction"]
    alive = carry["alive"]
    u_bsdf = u[3:6]
    u_rr = u[6]

    hit = decode_hit(o, d, t, prim, uv_bary, attr)
    valid = hit.valid & alive
    fnormal = pv.faceforward(hit.normal, -d, hit.gnormal)
    reflect_color = srgb_to_lrgb(hit.mat_color)

    throughput = carry["throughput"]
    radiance = carry["radiance"]
    brdf_pdf_prev = carry["brdf_pdf"]
    perfect_spec = carry["perfect_spec"]

    # miss: defer the env lookup; record direction + weight
    miss = alive & ~hit.valid
    carry_miss_dir = pv.where(miss, d, carry["miss_dir"])
    carry_miss_w = torch.where(miss[None], throughput, carry["miss_weight"])

    # emitter hit: terminate; without NEE there is no competing light
    # sampling technique, so the emission counts in full (MIS weight 1)
    is_light = valid & (hit.mat_type == C.MAT_LIGHT)
    radiance = radiance + torch.where(is_light[None], throughput * hit.mat_color, 0.0)

    is_glass = valid & (hit.mat_type == C.MAT_GLASS)
    g_dir, g_forb = glass_sample(u_bsdf[0], d, hit.normal, hit.mat_p0)

    is_disney = valid & (hit.mat_type != C.MAT_GLASS) & (hit.mat_type != C.MAT_LIGHT)
    d_dir = disney_sample(u_bsdf, d, fnormal, hit.mat_p0, hit.mat_p1)
    d_brdf, d_pdf = disney_evaluate_pdf(fnormal, -d, d_dir, hit.mat_p0, hit.mat_p1)
    d_brdf = d_brdf * torch.abs(pv.dot(hit.normal, d_dir))

    next_dir = pv.where(is_glass, g_dir, d_dir)
    f_or_b = torch.where(is_glass, g_forb, 1.0)
    brdf = torch.where(is_glass, 1.0, d_brdf)
    brdf_pdf = torch.where(is_glass, 1.0, d_pdf)
    new_perfect_spec = is_glass | (~is_disney & perfect_spec)

    next_origin = pv.offset_ray(hit.pos, fnormal * pv.sign_nonzero(f_or_b)[None])

    # Beer-Lambert transmission roulette
    transmitted = f_or_b < 0.0
    beer_r = torch.exp(-t / torch.clamp(hit.mat_p1, min=1e-12))
    beer_kill = transmitted & (u_rr >= beer_r)

    cont = (is_glass | is_disney) & (brdf_pdf > 0.0) & ~beer_kill
    throughput = torch.where(
        cont[None],
        throughput * (brdf / torch.clamp(brdf_pdf, min=1e-12))[None] * reflect_color,
        throughput,
    )
    return dict(
        # terminated lanes are parked far away: their tiles fail every
        # cluster slab test
        origin=pv.where(cont, next_origin, torch.full_like(o, 1e9)),
        direction=pv.where(cont, next_dir, d),
        throughput=throughput,
        radiance=radiance,
        alive=cont,
        brdf_pdf=torch.where(cont, brdf_pdf, brdf_pdf_prev),
        perfect_spec=torch.where(cont, new_perfect_spec, perfect_spec),
        miss_dir=carry_miss_dir,
        miss_weight=carry_miss_w,
        pixel=carry["pixel"],
    )


def _env_radiance(scene, d):
    """Equirect environment lookup of planar directions -> (3, N)."""
    if scene.env_img.shape[0] == 1 and scene.env_img.shape[1] == 1:
        return srgb_to_lrgb(scene.env_img[0, 0])[:, None] * scene.env_power
    dis = torch.sqrt(d[0] * d[0] + d[2] * d[2])
    tx = (torch.atan2(d[2], d[0]) + C.PI) / C.TWO_PI
    ty = torch.atan2(d[1], dis) / C.PI + 0.5
    rgb = texture2d_packed(scene.env_blocks, tx, ty)  # (N, 3)
    return srgb_to_lrgb(rgb).T * scene.env_power


def _camera_rays(spec, cam, frame: int, k_cam):
    """Full-film camera wavefront in static morton lane order: (o, d, inv)
    with o, d planar (3, N) and inv mapping raster pixel -> lane."""
    N = spec.width * spec.height
    o = cam.eye[:, None].expand(3, N)
    d = ray_directions_morton(spec, cam, frame, k_cam)
    _, inv = morton_pixel_order(spec.width, spec.height)
    return o, d, torch.as_tensor(inv, dtype=torch.int64, device=d.device)


def _to_raster(radiance, inv_perm):
    """Lane-space (3, N) radiance -> raster pixel order."""
    return radiance.index_select(1, inv_perm)


# ----------------------------------------------------- flush / compaction

def _flush(carry, accum, identity: bool = False, scene=None):
    """Bank the carry's radiance and pending env misses into the
    full-resolution accum pair (radiance (3, n), [miss_dir | miss_w]
    (6, n)) and clear them in the carry.  identity=True: the carry was
    never compacted (pixel == arange), so plain adds of both.  Otherwise
    (deep flushes) the pending misses are resolved here by one env lookup
    of `scene` and only radiance is scattered by pixel id."""
    rad, miss = accum
    has_miss = (carry["miss_weight"] != 0.0).any(dim=0)
    if identity:
        rad = rad + carry["radiance"]
        miss = miss + torch.cat([
            torch.where(has_miss[None], carry["miss_dir"], 0.0),
            torch.where(has_miss[None], carry["miss_weight"], 0.0),
        ])
    else:
        env = _env_radiance(scene, carry["miss_dir"])
        radiance = carry["radiance"] + torch.where(
            has_miss[None], env * carry["miss_weight"], 0.0)
        rad = rad.index_add(1, carry["pixel"], radiance)
    carry = dict(carry)
    for k in ("radiance", "miss_dir", "miss_weight"):
        carry[k] = torch.zeros_like(carry[k])
    return carry, (rad, miss)


def _new_accum(n, device):
    """Full-resolution flush buffers (radiance (3,n), [miss_dir|miss_w]
    (6,n))."""
    return (torch.zeros((3, n), dtype=torch.float32, device=device),
            torch.zeros((6, n), dtype=torch.float32, device=device))


def _phase_width(n: int, dv: int) -> int:
    """Compacted-phase width: n/dv with a 1024-lane floor, clamped to n."""
    return min(n, max(1024, n // dv))


def _compact(carry, new_n: int):
    """Shrink the wavefront to its live lanes (alive-first stable order,
    then the first new_n).  Returns (carry, overflow): live paths beyond
    new_n are killed and counted (a device int64 scalar)."""
    alive = carry["alive"]
    overflow = torch.clamp(alive.sum() - new_n, min=0)
    order = _stable_order((~alive).to(torch.int64))
    return _permute(carry, order[:new_n]), overflow


def _flush_compact(scene, carry, accum, new_n: int, pay_cap: int):
    """Fused deep-phase flush + compact: one stable 3-way order (alive <
    dead with payload < dead empty); the first new_n lanes become the new
    carry, the next pay_cap lanes are flushed (env misses resolved), the
    rest carry nothing.  Overflow counts live lanes beyond new_n and
    payload lanes pushed off the tail."""
    rad, miss_acc = accum
    alive = carry["alive"]
    has_pay = ((carry["radiance"] != 0.0).any(dim=0)
               | (carry["miss_weight"] != 0.0).any(dim=0))
    key3 = torch.where(alive, 0, torch.where(has_pay, 1, 2)).to(torch.int64)
    order = _stable_order(key3)[:new_n + pay_cap]
    m = _permute(carry, order)
    new_carry = {k: v[..., :new_n] for k, v in m.items()}
    tail = {k: v[..., new_n:] for k, v in m.items()}

    has_miss = (tail["miss_weight"] != 0.0).any(dim=0)
    env = _env_radiance(scene, tail["miss_dir"])
    radiance = tail["radiance"] + torch.where(has_miss[None], env * tail["miss_weight"], 0.0)
    rad = rad.index_add(1, tail["pixel"], radiance)

    n_alive = alive.sum()
    n_pay = (~alive & has_pay).sum()
    overflow = (torch.clamp(n_alive - new_n, min=0)
                + torch.clamp(n_alive + n_pay - (new_n + pay_cap), min=0))
    return new_carry, (rad, miss_acc), overflow


def has_nee_materials(scene) -> bool:
    """Does any material take the NEE branch?  Scenes of only glass and
    emitters (the 100k benchmark) get exactly zero from NEE."""
    mt = scene.mat_type.cpu()
    return bool(((mt != C.MAT_GLASS) & (mt != C.MAT_LIGHT)).any())


def _while_bounces(scene, carry, key, depth0: int, b1: int, presort: bool = False):
    """Bounces [depth0, b1), stopping early once no lane is alive (one
    host check per bounce)."""
    depth = depth0
    while depth < b1 and bool(carry["alive"].any()):
        carry = _bounce(scene, carry, rng.fold_in(key, depth), presort=presort)
        depth += 1
    return carry


# ---------------------------------------------------------------- renders

def trace_paths(scene, o, d, key, max_depth: int = MAX_DEPTH, compaction=None,
                nee: bool = False, return_overflow: bool = False, camera_origin=None):
    """Path-trace a pinhole camera wavefront in static morton lane order:
    (3, N) rays from camera_origin -> (3, N) radiance (and the overflow
    kill count, a device scalar, with return_overflow).

    compaction: ((start_bounce, shrink_divisor), ...) starting at bounce 1
    — after start_bounce bounces the wavefront shrinks to N/divisor
    lanes; deep phases presort the carry."""
    _check_path(nee, compaction)
    if camera_origin is None:
        raise NotImplementedError(_NO_SORT)
    dev = o.device
    N = o.shape[1]
    starts = [0] + [s for s, _ in compaction]
    ends = [s for s, _ in compaction] + [max_depth]
    widths = [N] + [_phase_width(N, dv) for _, dv in compaction]

    carry = _bounce(scene, _new_carry(o, d), rng.fold_in(key, 0),
                    shared_origin=camera_origin)
    accum_full = _new_accum(N, dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for phase, (b0, b1, width) in enumerate(zip(starts, ends, widths)):
        if phase == 0 or b0 >= max_depth:
            continue  # phase 0 is bounce 0, traced above
        carry, accum_full = _flush(carry, accum_full, identity=(phase == 1), scene=scene)
        carry, ov = _compact(carry, width)
        overflow = overflow + ov
        carry = _while_bounces(scene, carry, key, b0, min(b1, max_depth),
                               presort=needs_presort(scene))

    carry, (radiance_full, acc_miss) = _flush(carry, accum_full, scene=scene)
    missed = (acc_miss[3:6] != 0.0).any(dim=0)
    env = _env_radiance(scene, acc_miss[0:3])
    radiance = radiance_full + torch.where(missed[None], env * acc_miss[3:6], 0.0)
    if return_overflow:
        return radiance, overflow
    return radiance


def _image(spec, radiance, inv):
    """Lane-space (3, N) radiance -> (W, H, 3) film image."""
    return _to_raster(radiance, inv).T.reshape(spec.width, spec.height, 3)


def render_frame(scene, spec: CameraSpec, cam, frame: int, key, compaction=None,
                 nee: bool = False, max_depth: int = MAX_DEPTH):
    """One progressive frame (1 spp): (W, H, 3) radiance."""
    k_cam, k_path = rng.split(key)
    o, d, inv = _camera_rays(spec, cam, frame, k_cam)
    radiance = trace_paths(scene, o, d, k_path, compaction=compaction, nee=nee,
                           camera_origin=o[:, 0], max_depth=max_depth)
    return _image(spec, radiance, inv)


def render_film_frames(scene, spec: CameraSpec, cam, film, n_frames: int = 4,
                       compaction=None, nee: bool = False,
                       max_depth: int = MAX_DEPTH):
    """n progressive frames accumulated into the film, one after the
    other.  Returns (film', overflow kills as an int)."""
    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames):
        k_cam, k_path = rng.split(film.key)
        o, d, inv = _camera_rays(spec, cam, film.frame, k_cam)
        radiance, ov = trace_paths(
            scene, o, d, k_path, compaction=compaction, nee=nee,
            return_overflow=True, camera_origin=o[:, 0], max_depth=max_depth,
        )
        film = film_mod.accumulate(film, _image(spec, radiance, inv))
        total = total + ov
    return film, int(total)


def _render_group(scene, spec, cam, frame0: int, key0, group: int, compaction,
                  max_depth: int = MAX_DEPTH, pay_divisors=None):
    """`group` progressive frames with their compacted deep phases merged
    into one wavefront.  Returns (summed (W, H, 3) radiance, overflow).

    Camera rays and bounce 0 of frame g stay on the film's per-frame key
    chain; merged bounces draw from frame 0's path key over the
    concatenated wavefront (lane g*w1 + i belongs to frame g).  group=1
    reproduces the sequential loop (render_film_frames) exactly."""
    N = spec.width * spec.height
    w1 = _phase_width(N, compaction[0][1])
    dev = cam.eye.device

    carries, accums = [], []
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    key_f = key0
    for g in range(group):
        k_cam, k_path = rng.split(key_f)
        o, d, inv = _camera_rays(spec, cam, frame0 + g, k_cam)
        c = _bounce(scene, _new_carry(o, d), rng.fold_in(k_path, 0),
                    shared_origin=o[:, 0])
        c, accum = _flush(c, _new_accum(N, dev), identity=True)
        c, ovg = _compact(c, w1)
        c["pixel"] = c["pixel"] + g * N
        carries.append(c)
        accums.append(accum)
        overflow = overflow + ovg
        key_f = rng.split(key_f)[0]  # film.accumulate's key chain

    carry = {k: torch.cat([c[k] for c in carries], dim=-1) for k in carries[0]}
    accum_full = (torch.cat([a[0] for a in accums], dim=1),
                  torch.cat([a[1] for a in accums], dim=1))

    k_merge = rng.split(key0)[1]  # frame 0's path key
    starts = [s for s, _ in compaction]
    ends = starts[1:] + [max_depth]
    presort = needs_presort(scene)
    for i, ((b0, dv), b1) in enumerate(zip(compaction, ends)):
        if b0 >= max_depth:
            break
        b1 = min(b1, max_depth)
        if i > 0:
            w = group * _phase_width(N, dv)
            if pay_divisors is not None:
                carry, accum_full, ovg = _flush_compact(
                    scene, carry, accum_full, w,
                    group * _phase_width(N, pay_divisors[i - 1]))
            else:
                carry, accum_full = _flush(carry, accum_full, scene=scene)
                carry, ovg = _compact(carry, w)
            overflow = overflow + ovg
        carry = _while_bounces(scene, carry, k_merge, b0, b1, presort=presort)

    carry, (acc_rad, acc_miss) = _flush(carry, accum_full, scene=scene)
    missed = (acc_miss[3:6] != 0.0).any(dim=0)
    env = _env_radiance(scene, acc_miss[0:3])
    radiance = acc_rad + torch.where(missed[None], env * acc_miss[3:6], 0.0)
    img_sum = radiance.reshape(3, group, N).sum(dim=1)
    return _image(spec, img_sum, inv), overflow


def render_film_frames_merged(scene, spec: CameraSpec, cam, film,
                              n_frames: int = 16, group: int = 4,
                              compaction=None, nee: bool = False,
                              pay_divisors=None, max_depth: int = MAX_DEPTH):
    """n progressive frames traced in merged groups of `group` (see
    _render_group): the production path.  Requires a compaction schedule;
    the film ends on the same frame count and key chain as the sequential
    loop.  Returns (film', overflow kills as an int)."""
    _check_path(nee, compaction)
    if n_frames % group:
        raise ValueError(f"n_frames {n_frames} is not a multiple of group {group}")
    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames // group):
        img_sum, ov = _render_group(scene, spec, cam, film.frame, film.key, group,
                                    tuple(compaction), max_depth=max_depth,
                                    pay_divisors=pay_divisors)
        film = film_mod.accumulate_group(film, img_sum, group)
        total = total + ov
    return film, int(total)
