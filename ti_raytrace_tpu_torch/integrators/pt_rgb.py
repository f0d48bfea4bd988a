"""Wavefront RGB path tracer with next-event estimation and MIS (twin of
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

Tracer modes per bounce: the camera bounce of a pinhole wavefront is
coherent as generated (shared origin); bounces of the exact path and
bounces before the first compaction are coherence-sorted inside the
tracer (its sorted mode); compacted deep phases presort the carry and
trace with a per-tile order.  With `nee=True` every Disney hit traces one
shadow ray toward a sampled emitter point (sorted mode too) and weighs it
against BSDF sampling with the power heuristic.

Shading (`_shade`, from a bounce's hit record to the new carry) is one
launch of the hand kernel csrc/pt_shade.cu a bounce on the card, two under
NEE around sample_li and the shadow trace; CPU tensors take its plain twin
`_shade_plain`, which the kernel equals bit for bit.

Differences from the reference, by design: the carry's pixel ids are an
int64 tensor (not bitcast into the float carry); `_while_bounces` checks
for live lanes on the host once per bounce (one device sync per bounce);
overflow counts stay on the device until the end of a render call; the
merged prologue stops at max_depth.  The port's renders default to
nee=False (the benchmark's glass scene needs no NEE); callers choose NEE
with `has_nee_materials`, as the CLI does.  `corrected=True` (on
`trace_paths` and `render_frame`) divides BSDF-sampled bounces by the
sampler's true density, the ground truth of the corrected BDPT.  Not
ported: the reference's measured-loss switches (PRESORT_CARRY,
PRESORT_HALF, TRACE0_COMPACT, NEE_FROM_EMITTER_PARITY).
"""

import array

import torch

from ti_raytrace_tpu_torch import film as film_mod
from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.accel import needs_presort, trace, trace_shaded
from ti_raytrace_tpu_torch.bsdf.planar import disney_evaluate_pdf, disney_sample, glass_sample
from ti_raytrace_tpu_torch.camera import (CameraSpec, morton_pixel_order, ray_directions,
                                          ray_directions_morton, ray_origins)
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.ops import planar as pv
from ti_raytrace_tpu_torch.ops.cuda_build import F32, I32, I64, PTR, Launcher
from ti_raytrace_tpu_torch.ops.shading import decode_hit
from ti_raytrace_tpu_torch.scene.packs import PRIM_A
from ti_raytrace_tpu_torch.scene.sample_planar import sample_li
from ti_raytrace_tpu_torch.texture.texture import texture2d_packed
from ti_raytrace_tpu_torch.utils.colorsp import srgb_to_lrgb
from ti_raytrace_tpu_torch.utils.sampling import power_heuristic

MAX_DEPTH = 15


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
    morton) order: one stable sort of the composed 61-bit key
    (cluster_trace.sort_key with the alive mask: one launch on the card)."""
    from ti_raytrace_tpu_torch.ops.cluster_trace import key_route, sort_key

    o = carry["origin"]
    with metrics.span("trace.order", carry=True, route=key_route(o), n=o.shape[1]):
        key = sort_key(scene, o, carry["direction"], alive=carry["alive"])
        return _permute(carry, _stable_order(key))


# ---------------------------------------------------------------- bounce

def _bounce(scene, carry, key, depth: int, nee: bool = False, presort: bool = False,
            shared_origin=None, corrected: bool = False):
    """Bounce `depth` (its uniforms from fold_in(key, depth)): trace the
    carry's rays and shade the hits.
    shared_origin: a pinhole camera wavefront in static morton lane order
    (coherent as it is); presort=True: sort the carry first and trace
    with a per-tile front-to-back order (the compacted deep phases);
    otherwise the tracer coherence-sorts the rays around the trace (its
    sorted mode)."""
    with metrics.span("pt.bounce", depth=depth, width=carry["origin"].shape[1]):
        key = rng.fold_in(key, depth)
        if presort:
            carry = _sort_carry(scene, carry)
        o = carry["origin"]
        d = carry["direction"]
        u = rng.uniform(key, (8, o.shape[1]), device=o.device)
        t, prim, uv_bary, attr = trace_shaded(
            scene, o, d, sort_rays=not presort and shared_origin is None, sort_small=True,
            shared_origin=shared_origin, tile_order=presort)
        return _shade(scene, carry, u, t, prim, uv_bary, attr, nee, corrected)


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool

# csrc/pt_shade.cu's input slots in its order: (name, rows, dtype); rows
# None for a (N,) input, else (rows, N)
_SLOTS = (
    ("origin", 3, _F32), ("direction", 3, _F32), ("t", None, _F32), ("prim", None, _I32),
    ("uv_bary", 2, _F32), ("attr", PRIM_A, _F32), ("u", 8, _F32), ("throughput", 3, _F32),
    ("radiance", 3, _F32), ("alive", None, _BOOL), ("brdf_pdf", None, _F32),
    ("perfect_spec", None, _BOOL), ("miss_dir", 3, _F32), ("miss_weight", 3, _F32),
    ("light direction", 3, _F32), ("light normal", 3, _F32), ("light emission", 3, _F32),
    ("light dist", None, _F32), ("light choice_pdf", None, _F32), ("shadow prim", None, _I32),
)
_FULL, _HEAD, _TAIL = 0, 1, 2  # the kernel's modes


class _ShadeKernel(Launcher):
    """csrc/pt_shade.cu: one launch a shading step (full, or NEE's head and
    tail), and the probe of its powf / expf."""

    SOURCE = "pt_shade.cu"
    ENTRIES = {"pt_shade_launch": [PTR, I32, I32, I64, PTR, PTR, I64, PTR],
               "pt_math_launch": [I32, F32, PTR, PTR, I64, PTR]}
    ERROR = "pt_shade_error_string"

    @staticmethod
    def check(op, tensors):
        """Raise ValueError unless each input given (None: a slot the entry
        does not read) is a tensor of its slot's shape, (rows, N) or (N,)
        with N the lanes of `t`, and dtype, all on one CUDA device.  Returns
        (device, N).  Reads attributes only: no torch call."""
        t = tensors[2]
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"pt shade {op}: t must be a tensor, got {type(t).__name__}")
        if len(t.shape) != 1:
            raise ValueError(f"pt shade {op}: t must be (N,), got {tuple(t.shape)}")
        device, n = t.device, t.shape[0]
        for (name, rows, dtype), x in zip(_SLOTS, tensors):
            if x is None:
                continue
            if not isinstance(x, torch.Tensor):
                raise ValueError(f"pt shade {op}: {name} must be a tensor, got "
                                 f"{type(x).__name__}")
            want = (n,) if rows is None else (rows, n)
            if x.shape != want:
                raise ValueError(f"pt shade {op}: {name} must be {want}, got {tuple(x.shape)}")
            if x.dtype is not dtype:
                raise ValueError(f"pt shade {op}: {name} must be {dtype}, got {x.dtype}")
            if x.device != device:
                raise ValueError(f"pt shade {op}: the inputs lie on {device} and {x.device}")
        if device.type != "cuda":
            raise ValueError(f"pt shade {op}: the kernel runs on a CUDA device, got {device}")
        return device, n

    def _run(self, op, mode, tensors, shape, flag_rows, corrected=False, n_lights=0):
        """One launch of `mode` over `tensors` (in _SLOTS order, read by their
        strides) into a new contiguous float32 block of `shape` + (N,) and a
        (flag_rows, N) bool block; zero lanes launch nothing."""
        device, n = self.check(op, tensors)
        out = torch.empty((*shape, n), dtype=_F32, device=device)
        flags = torch.empty((flag_rows, n), dtype=_BOOL, device=device)
        if n:
            words = array.array("q")  # the kernel's words, read during the call
            for (_, r, _), x in zip(_SLOTS, tensors):
                if x is None:
                    words.extend((0, 0, 0))
                elif r is None:
                    words.extend((x.data_ptr(), 0, *x.stride()))
                else:
                    words.extend((x.data_ptr(), *x.stride()))
            self.launch("pt_shade_launch", device, words.buffer_info()[0], mode,
                        int(bool(corrected)), int(n_lights), out.data_ptr(), flags.data_ptr(), n)
        return out, flags

    @staticmethod
    def _carry_in(carry, u, t, prim, uv_bary, attr):
        return (carry["origin"], carry["direction"], t, prim, uv_bary, attr, u,
                carry["throughput"], carry["radiance"], carry["alive"], carry["brdf_pdf"],
                carry["perfect_spec"], carry["miss_dir"], carry["miss_weight"])

    def shade(self, carry, u, t, prim, uv_bary, attr, corrected: bool = False, nee=None):
        """_shade_plain's new carry by one launch: without `nee` the whole
        step (nee=False); with nee = (light sample dict of sample_li, the
        shadow rays' prims, scene.n_lights) the tail of the NEE step.  The
        float rows are views of one new (7, 3, N) block (brdf_pdf: row 0 of
        the last), the flags of one (2, N) block; `pixel` passes through."""
        ins = self._carry_in(carry, u, t, prim, uv_bary, attr)
        if nee is None:
            op, mode, n_lights = "full", _FULL, 0
            ins += (None,) * 6
        else:
            ls, sh_prim, n_lights = nee
            op, mode = "tail", _TAIL
            ins += (ls["direction"], ls["normal"], ls["emission"], ls["dist"],
                    ls["choice_pdf"], sh_prim)
        out, flags = self._run(op, mode, ins, (7, 3), 2, corrected, n_lights)
        origin, direction, throughput, radiance, miss_dir, miss_weight, brdf_pdf = out.unbind(0)
        alive, perfect_spec = flags.unbind(0)
        return dict(origin=origin, direction=direction, throughput=throughput,
                    radiance=radiance, alive=alive, brdf_pdf=brdf_pdf[0],
                    perfect_spec=perfect_spec, miss_dir=miss_dir, miss_weight=miss_weight,
                    pixel=carry["pixel"])

    def head(self, carry, t, prim, attr):
        """The NEE step's head by one launch: (pos (3, N), is_disney (1, N)),
        the hit positions of decode_hit and the lanes with a Disney hit."""
        ins = (carry["origin"], carry["direction"], t, prim, None, attr, None, None, None,
               carry["alive"]) + (None,) * 10
        return self._run("head", _HEAD, ins, (3,), 1)

    def math(self, x, exponent=None):
        """The probe: the kernel's pow_f(x, exponent), or exp_f(x) without an
        exponent, of a contiguous float32 CUDA tensor, one launch (the
        exponent is cast to float as ATen casts a Python one)."""
        if x.dtype != _F32 or x.device.type != "cuda" or not x.is_contiguous():
            raise ValueError("pt shade math: a contiguous float32 CUDA tensor")
        out = torch.empty_like(x)
        if x.numel():
            self.launch("pt_math_launch", x.device, int(exponent is not None), exponent or 0.0,
                        x.data_ptr(), out.data_ptr(), x.numel())
        return out


SHADE_KERNEL = _ShadeKernel()


def _shade(scene, carry, u, t, prim, uv_bary, attr, nee: bool = False,
           corrected: bool = False):
    """The post-trace half of _bounce (see _shade_plain): the kernel
    (SHADE_KERNEL, csrc/pt_shade.cu) when the hit record lies on a CUDA
    device, the plain twin otherwise.  On the kernel route nee=False is
    one launch; nee=True a head launch, sample_li and the shadow trace
    (`_shadow_trace`) in torch as in the twin, then a tail launch.  Each
    launch is a `pt.shade` span (route kernel, width, entry full, head or
    tail)."""
    if t.device.type != "cuda":
        return _shade_plain(scene, carry, u, t, prim, uv_bary, attr, nee, corrected)
    width = t.shape[0]
    if not nee:
        with metrics.span("pt.shade", route="kernel", width=width, entry="full"):
            return SHADE_KERNEL.shade(carry, u, t, prim, uv_bary, attr, corrected)
    with metrics.span("pt.shade", route="kernel", width=width, entry="head"):
        pos, is_disney = SHADE_KERNEL.head(carry, t, prim, attr)
    with metrics.span("pt.nee"):
        ls = sample_li(scene, pos, u[0:3])
        sh_o = _shadow_origins(ls, is_disney)
    sh_prim = _shadow_trace(scene, sh_o, ls["direction"])
    with metrics.span("pt.shade", route="kernel", width=width, entry="tail"):
        return SHADE_KERNEL.shade(carry, u, t, prim, uv_bary, attr, corrected,
                                  nee=(ls, sh_prim, scene.n_lights))


def _shadow_origins(ls, is_disney):
    """NEE's shadow-ray origins (3, N) from sample_li's result `ls`: the ray
    starts just off the sampled emitter point and must hit this lane's own
    prim first (the reference's unbiased default; its on-emitter variant is
    a measured-loss switch).  Lanes without a Disney hit (is_disney (1, N)
    false) are parked far outside the scene: their tiles fail every cluster
    slab test."""
    return torch.where(is_disney, pv.offset_ray(ls["pos"], ls["normal"]),
                       torch.full_like(ls["pos"], 1e9))


def _shadow_trace(scene, sh_o, sh_d):
    """NEE's shadow rays traced in the span `pt.shadow` (width): the dense
    sweep, or the cluster tracer's `trace.*` spans, below it.  Returns the
    prim each ray hits first."""
    with metrics.span("pt.shadow", width=sh_o.shape[1]):
        return trace(scene, sh_o, sh_d, sort_small=True)[1]


def _shade_plain(scene, carry, u, t, prim, uv_bary, attr, nee: bool = False,
                 corrected: bool = False):
    """The post-trace half of _bounce in tensor ops: emitter hits
    (MIS-weighted under NEE), NEE shadow rays, glass and Disney sampling,
    Beer-Lambert roulette and the carry update, from a hit record and
    per-lane uniforms u (8, N): rows 0:3 NEE, 3:6 BSDF, 6 roulette.
    corrected: the Disney pdfs are the sampler's true densities.  The
    plain twin of csrc/pt_shade.cu (`_shade` routes CPU tensors here)."""
    width = t.shape[0]
    with metrics.span("pt.shade", route="plain", width=width):
        o = carry["origin"]
        d = carry["direction"]
        alive = carry["alive"]
        u_nee = u[0:3]
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

        # emitter hit: terminate.  Under NEE the BSDF-sampled hit competes
        # with light sampling (power heuristic, camera and specular chains
        # count in full); without NEE the emission counts in full
        is_light = valid & (hit.mat_type == C.MAT_LIGHT)
        emitted = throughput * hit.mat_color
        if nee:
            fcos = torch.abs(pv.dot(d, hit.gnormal))
            area = hit.area * scene.n_lights
            light_pdf_hit = (t * t) / torch.clamp(area * fcos, min=1e-12)
            mis_w = torch.where(perfect_spec, 1.0, power_heuristic(brdf_pdf_prev, light_pdf_hit))
            emitted = mis_w[None] * throughput * hit.mat_color
        radiance = radiance + torch.where(is_light[None], emitted, 0.0)

        is_glass = valid & (hit.mat_type == C.MAT_GLASS)
        g_dir, g_forb = glass_sample(u_bsdf[0], d, hit.normal, hit.mat_p0)

        is_disney = valid & (hit.mat_type != C.MAT_GLASS) & (hit.mat_type != C.MAT_LIGHT)
    if nee:
        with metrics.span("pt.nee"):
            ls = sample_li(scene, hit.pos, u_nee)
            ndl_surf = pv.dot(fnormal, ls["direction"])
            ndl_light = pv.dot(ls["normal"], ls["direction"])
            nee_geo_ok = is_disney & (ndl_surf < 0.0) & (ndl_light > 0.0)
            sh_o = _shadow_origins(ls, is_disney[None])
        sh_prim = _shadow_trace(scene, sh_o, ls["direction"])
        with metrics.span("pt.nee"):
            unoccluded = sh_prim == prim
            nee_brdf, nee_pdf = disney_evaluate_pdf(fnormal, -d, -ls["direction"],
                                                    hit.mat_p0, hit.mat_p1, true_pdf=corrected)
            light_pdf = (ls["dist"] * ls["dist"] * ls["choice_pdf"]
                         / torch.clamp(ndl_light, min=1e-12))
            nee_ok = nee_geo_ok & unoccluded & (nee_pdf > 0.0)
            nee_w = (power_heuristic(light_pdf, nee_pdf) / torch.clamp(light_pdf, min=1e-4)
                     * nee_brdf * torch.abs(ndl_surf))
            radiance = radiance + torch.where(
                nee_ok[None], nee_w[None] * ls["emission"] * throughput * reflect_color, 0.0)

    with metrics.span("pt.shade", route="plain", width=width):
        d_dir = disney_sample(u_bsdf, d, fnormal, hit.mat_p0, hit.mat_p1)
        d_brdf, d_pdf = disney_evaluate_pdf(fnormal, -d, d_dir, hit.mat_p0, hit.mat_p1,
                                            true_pdf=corrected)
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
    return o, d, _upload_lanes(inv, d.device)


def _upload_lanes(inv, device):
    """The raster -> lane table on `device`: a pageable host-to-device copy,
    which drains the card's queue."""
    with metrics.span("sync.upload_lanes"):
        return torch.as_tensor(inv, dtype=torch.int64, device=device)


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


def _compact(carry, new_n: int, sp=None):
    """Shrink the wavefront to its live lanes (alive-first stable order,
    then the first new_n).  Returns (carry, overflow): live paths beyond
    new_n are killed and counted (a device int64 scalar).  Given the
    span `sp` of the compaction, a recording one also carries `live`,
    the live lanes before it, as a device scalar left unread."""
    alive = carry["alive"]
    live = alive.sum()
    if sp is not None and sp.id is not None:
        sp.attrs["live"] = live
    overflow = torch.clamp(live - new_n, min=0)
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
    with metrics.span("sync.nee_materials"):
        mt = scene.mat_type.cpu()
    return bool(((mt != C.MAT_GLASS) & (mt != C.MAT_LIGHT)).any())


def calibrate_compaction(scene, spec, cam, key=None, probe_size: int = 128,
                         margin: float = 4.0, max_depth: int = MAX_DEPTH):
    """Derive a safe compaction schedule from one probe frame.

    Traces a small probe wavefront (raster lane order, frame 1's jitter)
    bounce by bounce, records the live-lane fraction after each bounce,
    and returns a ((start_bounce, divisor), ...) schedule whose widths
    keep `margin` times headroom over the measured occupancy: at each
    bounce the largest power-of-two divisor (at most 64) that does, a new
    phase wherever it at least doubles.  Returns None when the scene
    keeps high occupancy (a closed diffuse box): compaction would not pay
    there."""
    key = key if key is not None else rng.PRNGKey(0)
    pspec = CameraSpec(probe_size, probe_size, focal=spec.focal)
    k_cam, k_path = rng.split(key)
    o = ray_origins(pspec, cam).T.contiguous()
    d = ray_directions(pspec, cam, 1, k_cam).T.contiguous()
    nee = has_nee_materials(scene)
    presort = needs_presort(scene)
    carry = _new_carry(o, d)
    frac = []
    for depth in range(max_depth):
        carry = _bounce(scene, carry, k_path, depth, nee, presort=presort)
        frac.append(float(carry["alive"].float().mean()))
        if frac[-1] == 0.0:
            break

    schedule = []
    div_prev = 1
    for depth, f in enumerate(frac):
        div = 1
        while div < 64 and f * margin <= 1.0 / (2 * div):
            div *= 2
        if div >= 2 * div_prev:
            schedule.append((depth + 1, div))
            div_prev = div
    return tuple(schedule) if schedule else None


def _while_bounces(scene, carry, key, depth0: int, b1: int, nee: bool = False,
                   presort: bool = False, corrected: bool = False):
    """Bounces [depth0, b1), stopping early once no lane is alive (one
    host check per bounce)."""
    depth = depth0
    while depth < b1 and _any_alive(carry):
        carry = _bounce(scene, carry, key, depth, nee, presort=presort, corrected=corrected)
        depth += 1
    return carry


def _any_alive(carry) -> bool:
    """Is any lane of the carry alive?  A read of a device value: the host
    waits for the card's queue to drain."""
    with metrics.span("sync.alive"):
        return bool(carry["alive"].any())


def _overflow_int(total) -> int:
    """A render call's device overflow count as an int (a host read)."""
    with metrics.span("sync.overflow"):
        return int(total)


# ---------------------------------------------------------------- renders

def trace_paths(scene, o, d, key, max_depth: int = MAX_DEPTH, compaction=None,
                nee: bool = False, return_overflow: bool = False,
                corrected: bool = False, camera_origin=None):
    """Path-trace a wavefront: (3, N) rays -> (3, N) radiance (and the
    overflow kill count, a device scalar, with return_overflow).

    camera_origin: the wavefront is a pinhole camera's in static morton
    lane order; bounce 0 then traces with that shared origin, unsorted.
    compaction: ((start_bounce, shrink_divisor), ...) — after start_bounce
    bounces the wavefront shrinks to N/divisor lanes and the deep phases
    presort the carry; None (or empty) is the exact path: every bounce at
    full width, traced in the sorted mode, one env fold at the end.
    corrected: divide BSDF-sampled bounces by the sampler's true density
    (the unbiased estimator the corrected BDPT converges to)."""
    dev = o.device
    N = o.shape[1]

    def start(carry):
        if camera_origin is None:
            return 0, carry
        return 1, _bounce(scene, carry, key, 0, nee, shared_origin=camera_origin,
                          corrected=corrected)

    with metrics.span("pt.camera"):
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        carry = _new_carry(o, d)
    if not compaction:
        depth0, carry = start(carry)
        carry = _while_bounces(scene, carry, key, depth0, max_depth, nee,
                               corrected=corrected)
        with metrics.span("pt.env"):
            missed = (carry["miss_weight"] != 0.0).any(dim=0)
            env = _env_radiance(scene, carry["miss_dir"])
            radiance = carry["radiance"] + torch.where(missed[None], env * carry["miss_weight"],
                                                       0.0)
        return (radiance, overflow) if return_overflow else radiance

    starts = [0] + [s for s, _ in compaction]
    ends = [s for s, _ in compaction] + [max_depth]
    widths = [N] + [_phase_width(N, dv) for _, dv in compaction]
    with metrics.span("pt.camera"):
        accum_full = _new_accum(N, dev)
    for phase, (b0, b1, width) in enumerate(zip(starts, ends, widths)):
        if b0 >= max_depth:
            break
        if phase == 0:
            depth0, carry = start(carry)
        else:
            with metrics.span("pt.flush_compact", width_in=carry["alive"].shape[0],
                              width_out=width) as sp:
                carry, accum_full = _flush(carry, accum_full, identity=(phase == 1),
                                           scene=scene)
                carry, ov = _compact(carry, width, sp)
                overflow = overflow + ov
            depth0 = b0
        carry = _while_bounces(scene, carry, key, depth0, min(b1, max_depth), nee,
                               presort=phase > 0 and needs_presort(scene),
                               corrected=corrected)

    with metrics.span("pt.env"):
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


def render_frame_stats(scene, spec: CameraSpec, cam, frame: int, key, compaction=None,
                       nee: bool = False, corrected: bool = False,
                       max_depth: int = MAX_DEPTH):
    """One progressive frame (1 spp) and its overflow kill count: ((W, H,
    3) radiance, a device scalar; > 0 means the compaction schedule cut
    live paths)."""
    k_cam, k_path = rng.split(key)
    o, d, inv = _camera_rays(spec, cam, frame, k_cam)
    radiance, overflow = trace_paths(scene, o, d, k_path, compaction=compaction, nee=nee,
                                     return_overflow=True, corrected=corrected,
                                     camera_origin=o[:, 0], max_depth=max_depth)
    return _image(spec, radiance, inv), overflow


def render_frame(scene, spec: CameraSpec, cam, frame: int, key, compaction=None,
                 nee: bool = False, corrected: bool = False,
                 max_depth: int = MAX_DEPTH):
    """One progressive frame (1 spp): (W, H, 3) radiance."""
    return render_frame_stats(scene, spec, cam, frame, key, compaction, nee, corrected,
                              max_depth)[0]


def render_film_frames(scene, spec: CameraSpec, cam, film, n_frames: int = 4,
                       compaction=None, nee: bool = False,
                       max_depth: int = MAX_DEPTH):
    """n progressive frames accumulated into the film, one after the
    other.  Returns (film', overflow kills as an int)."""
    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames):
        with metrics.span("pt.camera"):
            k_cam, k_path = rng.split(film.key)
            o, d, inv = _camera_rays(spec, cam, film.frame, k_cam)
        radiance, ov = trace_paths(
            scene, o, d, k_path, compaction=compaction, nee=nee,
            return_overflow=True, camera_origin=o[:, 0], max_depth=max_depth,
        )
        with metrics.span("film.accumulate"):
            film = film_mod.accumulate(film, _image(spec, radiance, inv))
            total = total + ov
    return film, _overflow_int(total)


def _render_group(scene, spec, cam, frame0: int, key0, group: int, compaction,
                  nee: bool = False, max_depth: int = MAX_DEPTH, pay_divisors=None,
                  gen_rays=None, lane_space: bool = False, n_lanes: int = None):
    """`group` progressive frames with their compacted deep phases merged
    into one wavefront.  Returns (summed (W, H, 3) radiance, overflow).

    Camera rays and the bounces before the first compaction (bounce 0
    shared-origin, the rest sorted) of frame g stay on the film's
    per-frame key chain; merged bounces draw from frame 0's path key over
    the concatenated wavefront (lane g*w1 + i belongs to frame g).
    group=1 reproduces the sequential loop (render_film_frames) exactly.

    gen_rays(frame, k_cam) -> (o, d): a pinhole wavefront of n_lanes rays
    sharing one origin, in place of the whole film's morton camera
    wavefront (the sharded path renders each rank's interleaved blocks of
    morton lanes, parallel/shard.py).  lane_space=True returns the summed
    radiance as (3, n_lanes) in lane order, without the raster unpermute."""
    N = n_lanes if n_lanes is not None else spec.width * spec.height
    b_merge, dv0 = compaction[0]
    w1 = _phase_width(N, dv0)
    dev = cam.eye.device
    if gen_rays is None:
        def gen_rays(frame, k_cam):
            return _camera_rays(spec, cam, frame, k_cam)[:2]

    carries, accums = [], []
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    key_f = key0
    for g in range(group):
        with metrics.span("pt.camera"):
            k_cam, k_path = rng.split(key_f)
            o, d = gen_rays(frame0 + g, k_cam)
            c = _new_carry(o, d)
        c = _bounce(scene, c, k_path, 0, nee, shared_origin=o[:, 0])
        for depth in range(1, min(b_merge, max_depth)):
            c = _bounce(scene, c, k_path, depth, nee)
        with metrics.span("pt.flush_compact", width_in=c["alive"].shape[0], width_out=w1):
            c, accum = _flush(c, _new_accum(N, dev), identity=True)
            c, ovg = _compact(c, w1)
            c["pixel"] = c["pixel"] + g * N
            carries.append(c)
            accums.append(accum)
            overflow = overflow + ovg
            key_f = rng.split(key_f)[0]  # film.accumulate's key chain

    with metrics.span("pt.flush_compact", width_in=group * w1, width_out=group * w1):
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
            with metrics.span("pt.flush_compact", width_in=carry["alive"].shape[0],
                              width_out=w):
                if pay_divisors is not None:
                    carry, accum_full, ovg = _flush_compact(
                        scene, carry, accum_full, w,
                        group * _phase_width(N, pay_divisors[i - 1]))
                else:
                    carry, accum_full = _flush(carry, accum_full, scene=scene)
                    carry, ovg = _compact(carry, w)
                overflow = overflow + ovg
        carry = _while_bounces(scene, carry, k_merge, b0, b1, nee, presort=presort)

    with metrics.span("pt.env"):
        carry, (acc_rad, acc_miss) = _flush(carry, accum_full, scene=scene)
        missed = (acc_miss[3:6] != 0.0).any(dim=0)
        env = _env_radiance(scene, acc_miss[0:3])
        radiance = acc_rad + torch.where(missed[None], env * acc_miss[3:6], 0.0)
        img_sum = radiance.reshape(3, group, N).sum(dim=1)
        if lane_space:
            return img_sum, overflow
        _, inv = morton_pixel_order(spec.width, spec.height)
        return _image(spec, img_sum, _upload_lanes(inv, dev)), overflow


def render_film_frames_merged(scene, spec: CameraSpec, cam, film,
                              n_frames: int = 16, group: int = 4,
                              compaction=None, nee: bool = False,
                              pay_divisors=None, max_depth: int = MAX_DEPTH):
    """n progressive frames traced in merged groups of `group` (see
    _render_group): the production path.  Requires a compaction schedule;
    the film ends on the same frame count and key chain as the sequential
    loop.  Returns (film', overflow kills as an int)."""
    if not compaction:
        raise ValueError("merged rendering requires a compaction schedule")
    if n_frames % group:
        raise ValueError(f"n_frames {n_frames} is not a multiple of group {group}")
    total = torch.zeros((), dtype=torch.int64, device=film.hdr.device)
    for _ in range(n_frames // group):
        img_sum, ov = _render_group(scene, spec, cam, film.frame, film.key, group,
                                    tuple(compaction), nee, max_depth=max_depth,
                                    pay_divisors=pay_divisors)
        with metrics.span("film.accumulate"):
            film = film_mod.accumulate_group(film, img_sum, group)
            total = total + ov
    return film, _overflow_int(total)
