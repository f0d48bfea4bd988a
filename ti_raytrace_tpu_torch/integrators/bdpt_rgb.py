"""Bidirectional path tracer with multiple importance sampling, RGB (twin
of ti_raytrace_tpu/integrators/bdpt_rgb.py).

The eye subpath (<= max_depth + 2 vertices) and the light subpath
(<= max_depth + 1) are built by wavefront walks whose per-depth vertices
are dicts of planar (3, N) / (N,) tensors; each depth's eye and light
traces run as one fused wavefront.  Every (e, l) connection strategy is a
masked whole-wavefront block, and every strategy's shadow ray is traced
in ONE batch whose rays carry their target distance as a per-lane `tmax`
(the cluster kernel seeds its best hit with it; parked lanes get a 1e-3
bound that prunes the whole scene).  The MIS weight is evaluated
functionally, the endpoint reverse pdfs passed in as overrides.

The e = 1 light-tracing strategies splat into the film at a projected
pixel.  Float atomics on CUDA add in an order that changes from run to
run, so the splats of a frame are added by ONE `index_put_(accumulate=
True)` under `torch.use_deterministic_algorithms`, scoped to that call:
on CUDA a sort by pixel id and an ordered sum per pixel, on the CPU a
serial loop in lane order, strategy after strategy, as the reference's
per-strategy scatter-adds.  Lanes outside a strategy's selection add
zero in the reference; here they go to SPLAT_DUMP spare rows past the
film (spread, so that no pixel id repeats a million times: one long run
of a sort-based sum is serial), which are dropped.  A frame rendered
twice from one key is bit-equal.

The reference's estimator is the default (`corrected=False`), with its
material-index quirk in the MIS weights (_QUIRK_MAT_INDEX, replicated
verbatim: the goldens embody it); `corrected=True` is the standard
vertex-area-measure estimator that converges to the corrected PT.

Differences from the reference, by design: the walk's compaction
overflow is returned (the reference drops it in `_walk`) and, with a
shadow cap, the live shadow lanes cut at capacity are added to it
(render entry points take `return_overflow`); rays are generated once
per sliced frame instead of once per slice (the same rays and keys); no
jit.

The spectral variant (integrators/bdpt_spec.py) runs the same walks and
connections with a `spec_ctx`: one wavelength per lane, betas and
reflectances one row wide (the per-depth vertex rows stay three wide; the
one row broadcasts into them), BK7 glass dispersed at the lane's
wavelength, emitter power from the packed spectral rows, and the
conversion to sRGB per lane before the splat and at the end of the frame.
With `spec_ctx=None` every result is the RGB one, bit for bit.
"""

import functools

import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.accel import trace, trace_capacity, trace_shaded
from ti_raytrace_tpu_torch.bsdf.planar import disney_evaluate_pdf, disney_sample, glass_sample
from ti_raytrace_tpu_torch.camera import CameraSpec, project, ray_directions, ray_origins
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import frame_graph
from ti_raytrace_tpu_torch.ops import planar as pv
from ti_raytrace_tpu_torch.ops.shading import decode_hit
from ti_raytrace_tpu_torch.scene.sample_planar import sample_li, sample_light
from ti_raytrace_tpu_torch.utils.colorsp import srgb_to_lrgb
from ti_raytrace_tpu_torch.utils.geometry import bk7_ior

MAX_DEPTH = 5
EYE_MAX_DEPTH = MAX_DEPTH + 2
LIGHT_MAX_DEPTH = MAX_DEPTH + 1

V_NONE, V_LIGHT, V_LENS, V_SURFACE = 0, 1, 2, 3

PARK = 1e9

# the reference's MIS compares the material INDEX against MAT_DISNEY == 0
# at three sites; the published goldens embody it
_QUIRK_MAT_INDEX = True

# occupancy cap of the fused shadow batch (fraction of its lanes the
# kernel runs on); None: no cap.  Parked lanes already prune the whole
# scene through their 1e-3 bound, so the exact default costs them little.
SHADOW_CAP = None

SPLAT_DUMP = 1 << 14  # spare splat rows for unselected lanes (see above)


def _quirk_is_disney(v):
    if _QUIRK_MAT_INDEX:
        return v["mat_index"] == 0
    return v["mat_type"] == C.MAT_DISNEY


def _cos_pdf(c):
    return torch.clamp(c / C.PI, min=0.01)


@metrics.spanned("bdpt.pdf")
def _disney_pdf(n, v, l, metallic, roughness, true_pdf: bool = False):
    _, p = disney_evaluate_pdf(n, v, l, metallic, roughness, true_pdf=true_pdf)
    return torch.clamp(p, min=0.0)


# (brdf, pdf) of bsdf/planar, as a span of its own
_evaluate_pdf = metrics.spanned("bdpt.pdf")(disney_evaluate_pdf)


# ------------------------------------------------------------------- walk

def _empty_vertex(N, device):
    z3 = torch.zeros((3, N), dtype=torch.float32, device=device)
    z = torch.zeros((N,), dtype=torch.float32, device=device)
    zi = torch.zeros((N,), dtype=torch.int32, device=device)
    return dict(
        pos=z3, normal=z3, snormal=z3, wo=z3, beta=z3, reflect=z3,
        fpdf=z, rpdf=z, delta=z, area=z, metallic=z, roughness=z,
        vtype=zi, prim=torch.full((N,), -1, dtype=torch.int32, device=device),
        mat_type=zi, mat_index=zi,
    )


def _walk_state(origin, direction, beta0, fpdf0, vertex0, max_depth, spec_ctx=None):
    """Walk carry: per-depth vertex dicts + the ray front.  The front also
    carries the previous vertex's pos/normal and each lane's original lane
    id, so it can be compacted mid-walk: vertex writes then scatter back
    to the original lane slots (`compacted` True).  A spectral walk's
    front also carries each lane's wavelength and D65 value (`lam`,
    `d65`), which shrink with it."""
    N = origin.shape[1]
    dev = origin.device
    st = {
        "verts": [vertex0] + [_empty_vertex(N, dev) for _ in range(max_depth - 1)],
        "count": torch.ones((N,), dtype=torch.int32, device=dev),
        "o": origin,
        "d": direction,
        "beta": beta0,
        "pdf_fwd": fpdf0,
        "alive": torch.ones((N,), dtype=torch.bool, device=dev),
        "lane": torch.arange(N, dtype=torch.int64, device=dev),
        "prev_pos": vertex0["pos"],
        "prev_normal": vertex0["normal"],
        "compacted": False,
        "n_full": N,
    }
    if spec_ctx is not None:
        st["lam"] = spec_ctx.lam
        st["d65"] = spec_ctx.d65_val
    return st


def _walk_width(N: int, dv) -> int:
    """Compacted front width: N/dv rounded up to a 128-lane multiple."""
    w = int(N / float(dv))
    return min(N, max(128, (w + 127) // 128 * 128))


def _compact_walk_front(st, new_n: int, side: str | None = None, depth: int | None = None):
    """Alive-first stable order + prefix of new_n lanes of the walk front.
    Live lanes beyond capacity end their subpath here (a shorter walk:
    a bias, so the count is returned as a device scalar).  Runs in the
    span `bdpt.compact_walk` (the walk's `side` and `depth`, the front's
    `width_in` and the `capacity` new_n); recording on the card, the span
    also carries `live`, the front's live lanes as a device scalar, left
    unread."""
    alive = st["alive"]
    with metrics.span("bdpt.compact_walk", side=side, depth=depth, width_in=alive.shape[0],
                      capacity=new_n) as sp:
        live = alive.sum()
        if sp.id is not None and alive.device.type == "cuda":
            sp.attrs["live"] = live
        overflow = torch.clamp(live - new_n, min=0)
        sel = torch.sort((~alive).to(torch.int64), stable=True).indices[:new_n]
        c = st["beta"].shape[0]  # 3, or 1 on a spectral walk
        spectral = "lam" in st
        rows = torch.cat([st["o"], st["d"], st["beta"], st["pdf_fwd"][None],
                          st["prev_pos"], st["prev_normal"]]
                         + ([st["lam"][None], st["d65"][None]] if spectral else [])
                         ).index_select(1, sel)
        st["o"], st["d"], st["beta"] = rows[0:3], rows[3:6], rows[6:6 + c]
        st["pdf_fwd"] = rows[6 + c]
        st["prev_pos"], st["prev_normal"] = rows[7 + c:10 + c], rows[10 + c:13 + c]
        if spectral:
            st["lam"], st["d65"] = rows[13 + c], rows[14 + c]
        st["alive"] = alive.index_select(0, sel)
        st["lane"] = st["lane"].index_select(0, sel)
        st["compacted"] = True
        return overflow


def _scatter_drop(base, idx, upd):
    """base (R, n) with columns idx (w,) replaced by upd (R, w); columns
    with idx == n are dropped (the reference's scatter mode='drop')."""
    ext = torch.cat([base, base.new_zeros((base.shape[0], 1))], dim=1)
    return ext.index_copy_(1, idx, upd)[:, :-1]


def _walk(scene, origin, direction, beta0, fpdf0, vertex0, max_depth, key,
          is_light_path, corrected: bool = False, compaction=None, spec_ctx=None):
    """One subpath random walk.  compaction: optional ((depth, divisor),
    ...): before the trace at `depth` the front shrinks to width/divisor
    (alive first).  Returns (per-depth vertex dicts, per-lane vertex
    count, overflow device scalar)."""
    st = _walk_state(origin, direction, beta0, fpdf0, vertex0, max_depth, spec_ctx)
    N = origin.shape[1]
    sched = dict(compaction or ())
    overflow = torch.zeros((), dtype=torch.int64, device=origin.device)
    side = "light" if is_light_path else "eye"
    for depth in range(1, max_depth):
        with metrics.span("bdpt.walk", side=side, depth=depth, width=st["o"].shape[1]):
            if depth in sched:
                overflow = overflow + _compact_walk_front(st, _walk_width(N, sched[depth]),
                                                          side, depth)
            o_t = pv.where(st["alive"], st["o"], torch.full_like(st["o"], PARK))
        traced = trace_shaded(scene, o_t, st["d"])
        with metrics.span("bdpt.walk", side=side, depth=depth, width=o_t.shape[1]):
            _walk_step(scene, st, depth, key, is_light_path, corrected, o_t, traced, spec_ctx)
    return st["verts"], st["count"], overflow


def _walk_step(scene, st, depth, key, is_light_path, corrected, o_t, traced, spec_ctx=None):
    """One walk depth from this depth's hit record; updates st.  Runs at
    the front's width; a compacted front writes the depth's vertex
    through one packed scatter back to the original lane slots.  A
    spectral walk reads the wavelength rows of the front, not of the
    full-width `spec_ctx` it was started from."""
    N = o_t.shape[1]
    verts, count = st["verts"], st["count"]
    d, beta, pdf_fwd, alive = st["d"], st["beta"], st["pdf_fwd"], st["alive"]
    compacted = st["compacted"]
    N_full = st["n_full"]
    if spec_ctx is not None:
        spec_ctx = spec_ctx._replace(lam=st["lam"], d65_val=st["d65"])

    u = rng.uniform(rng.fold_in(key, depth), (5, N), device=o_t.device)

    t, prim, uv_bary, attr = traced
    hit = decode_hit(o_t, d, t, prim, uv_bary, attr)
    valid = hit.valid & alive
    fnormal = pv.faceforward(hit.normal, -d, hit.gnormal)
    reflect = srgb_to_lrgb(hit.mat_color) if spec_ctx is None else spec_ctx.reflect_power(attr)
    is_light_mat = hit.mat_type == C.MAT_LIGHT

    prev_pos, prev_normal = st["prev_pos"], st["prev_normal"]
    to = hit.pos - prev_pos
    dist = torch.clamp(pv.length(to), min=0.01)
    inv_d2 = 1.0 / (dist * dist)
    to = to * (1.0 / dist)[None]
    # corrected: the area conversion's cosine at the NEW vertex; the
    # reference's: at the previous one
    geo_fwd = torch.abs(pv.dot(to, hit.normal if corrected else prev_normal)) * inv_d2

    if is_light_path:
        # the light walk stops on emitter hits without storing a vertex
        store = valid & ~is_light_mat
        beta_v = beta * torch.abs(pv.dot(d, hit.normal))[None]
        vtype_v = torch.full((N,), V_SURFACE, dtype=torch.int32, device=d.device)
        continue_mask = store
    else:
        # an emitter hit ends the eye walk with a light vertex whose beta
        # folds the emission and |n.d| (the spectral walk: the light power,
        # without the cosine)
        store = valid
        lhit = valid & is_light_mat
        if spec_ctx is None:
            light_beta = beta * hit.mat_color * torch.abs(pv.dot(hit.normal, d))[None]
        else:
            light_beta = beta * spec_ctx.light_power_attr(attr)
        beta_v = pv.where(lhit, light_beta, beta * torch.abs(pv.dot(d, hit.normal))[None])
        vtype_v = torch.where(lhit, V_LIGHT, V_SURFACE).to(torch.int32)
        continue_mask = valid & ~is_light_mat
    is_glass = continue_mask & (hit.mat_type == C.MAT_GLASS)

    # this depth's vertex, written where `store`
    vt = verts[depth]
    # the vertex rows of reflect and beta are 3 wide: a spectral walk's one
    # row broadcasts into them
    vecs = dict(pos=hit.pos, normal=hit.normal, snormal=fnormal, wo=d,
                reflect=reflect.expand(3, N), beta=beta_v.expand(3, N))
    scals = dict(fpdf=pdf_fwd * geo_fwd, metallic=hit.mat_p0, roughness=hit.mat_p1,
                 area=hit.area, delta=torch.where(is_glass, 1.0, 0.0))
    ints = dict(prim=prim, mat_type=hit.mat_type, mat_index=attr[30].to(torch.int32),
                vtype=vtype_v)
    if not compacted:
        for k, v in vecs.items():
            vt[k] = pv.where(store, v, vt[k])
        for k, v in (scals | ints).items():
            vt[k] = torch.where(store, v, vt[k])
        count = torch.where(store, depth + 1, count)
    else:
        # packed scatters back to the original lane slots; lanes outside
        # `store` index past the end and drop
        idx = torch.where(store, st["lane"], N_full)
        f = _scatter_drop(torch.cat([vt[k] for k in vecs] + [vt[k][None] for k in scals]),
                          idx, torch.cat(list(vecs.values()) + [v[None] for v in scals.values()]))
        for i, k in enumerate(vecs):
            vt[k] = f[3 * i:3 * i + 3]
        for i, k in enumerate(scals):
            vt[k] = f[3 * len(vecs) + i]
        depth_v = torch.full_like(count[:N], depth + 1)
        n = _scatter_drop(torch.stack([vt[k] for k in ints] + [count]), idx,
                          torch.stack(list(ints.values()) + [depth_v]))
        for i, k in enumerate(ints):
            vt[k] = n[i]
        count = n[len(ints)]

    # ---- sample the continuation
    # spectral: BK7 glass dispersed at the lane's wavelength
    glass_ior = hit.mat_p0 if spec_ctx is None else bk7_ior(spec_ctx.lam)
    g_dir, g_forb = glass_sample(u[0], d, hit.normal, glass_ior)
    d_dir = disney_sample(u[0:3], d, fnormal, hit.mat_p0, hit.mat_p1)
    d_brdf, d_pdf = _evaluate_pdf(fnormal, -d, d_dir, hit.mat_p0, hit.mat_p1,
                                  true_pdf=corrected)

    next_dir = pv.where(is_glass, g_dir, d_dir)
    f_or_b = torch.where(is_glass, g_forb, 1.0)
    brdf = torch.where(is_glass, 1.0, d_brdf)
    pdf_new = torch.where(is_glass, 1.0, d_pdf)

    ok = continue_mask & (pdf_new > 0.0)

    # reverse pdf of the PREVIOUS vertex
    pdf_rev = torch.where(is_glass, 0.0, _disney_pdf(fnormal, next_dir, -d, hit.mat_p0,
                                                     hit.mat_p1, true_pdf=corrected))
    # corrected: the area measure at the previous vertex (its cosine)
    geo_rev = torch.abs(pv.dot(to, prev_normal if corrected else hit.normal)) * inv_d2
    prev_ref = verts[depth - 1]
    rpdf_v = pdf_rev * geo_rev
    if not compacted:
        prev_ref["rpdf"] = torch.where(ok, rpdf_v, prev_ref["rpdf"])
    else:
        idx_ok = torch.where(ok, st["lane"], N_full)
        prev_ref["rpdf"] = _scatter_drop(prev_ref["rpdf"][None], idx_ok, rpdf_v[None])[0]

    beta_scale = torch.where(
        is_glass, brdf,
        brdf * torch.abs(pv.dot(hit.normal, next_dir)) / torch.clamp(pdf_new, min=1e-12))
    beta = pv.where(ok, beta * reflect * beta_scale[None], beta)
    pdf_fwd = torch.where(is_glass, 0.0, torch.where(ok, pdf_new, pdf_fwd))

    # Beer-Lambert roulette on transmission
    beer_r = torch.exp(-t / torch.clamp(hit.mat_p1, min=1e-12))
    ok = ok & ~((f_or_b < 0.0) & (u[4] >= beer_r))

    st["count"] = count
    st["o"] = pv.where(ok, pv.offset_ray(hit.pos, fnormal * pv.sign_nonzero(f_or_b)[None]),
                       st["o"])
    st["d"] = pv.where(ok, next_dir, d)
    st["beta"], st["pdf_fwd"], st["alive"] = beta, pdf_fwd, ok
    # the next step's previous vertex is this depth's stored vertex
    zero3 = torch.zeros_like(hit.pos)
    st["prev_pos"] = pv.where(store, hit.pos, zero3)
    st["prev_normal"] = pv.where(store, hit.normal, zero3)


def _eye_vertex0(o, d, channels: int = 3):
    N = o.shape[1]
    v0 = _empty_vertex(N, o.device)
    v0["pos"] = o
    v0["normal"] = d  # the reference stores the ray direction here
    v0["beta"] = torch.ones((channels, N), dtype=torch.float32, device=o.device)
    v0["fpdf"] = torch.ones((N,), dtype=torch.float32, device=o.device)
    v0["vtype"] = torch.full((N,), V_LENS, dtype=torch.int32, device=o.device)
    return v0


def _channels(spec_ctx) -> int:
    """Rows of a walk's beta: 3 (RGB), or 1 at a single wavelength."""
    return 3 if spec_ctx is None else 1


def build_eye_path_rays(scene, o, d, key, eye_depth: int = EYE_MAX_DEPTH, fpdf0=None,
                        corrected: bool = False, spec_ctx=None):
    """Eye subpath walk from explicit planar rays.  fpdf0: per-lane camera
    direction pdf (the reference's weights take it as 1; the corrected
    estimator passes the pinhole pdf).  Returns (verts, count, overflow)."""
    N = o.shape[1]
    c = _channels(spec_ctx)
    ones = torch.ones((N,), dtype=torch.float32, device=o.device)
    return _walk(scene, o, d, torch.ones((c, N), dtype=torch.float32, device=o.device),
                 ones if fpdf0 is None else fpdf0, _eye_vertex0(o, d, c), eye_depth, key,
                 is_light_path=False, corrected=corrected, spec_ctx=spec_ctx)


def _camera_dir_pdf(spec, cam, d):
    """Pinhole direction pdf fx*fy/cos^3(theta) (film in pixels) of planar
    directions d."""
    axis = cam.view[2, :3]
    cos_t = torch.clamp(torch.abs(pv.dot(d, axis[:, None].expand_as(d))), min=1e-3)
    return spec.fx * spec.fy / (cos_t * cos_t * cos_t)


def _camera_rays(spec, cam, frame, k_cam):
    """Raster-order planar camera rays (3, N) of the full film."""
    return ray_origins(spec, cam).T, ray_directions(spec, cam, frame, k_cam).T


def build_eye_path(scene, spec, cam, frame, key, eye_depth: int = EYE_MAX_DEPTH,
                   corrected: bool = False, spec_ctx=None):
    k_cam, k_walk = rng.split(key)
    o, d = _camera_rays(spec, cam, frame, k_cam)
    fpdf0 = _camera_dir_pdf(spec, cam, d) if corrected else None
    return build_eye_path_rays(scene, o, d, k_walk, eye_depth, fpdf0=fpdf0,
                               corrected=corrected, spec_ctx=spec_ctx)


def _light_init(scene, N, k_sample, corrected: bool = False, spec_ctx=None):
    """Light subpath start: sampled emitter vertex + first ray.
    Returns (o, d, beta0, dir_pdf, v0)."""
    dev = scene.device
    ls = sample_light(scene, rng.uniform(k_sample, (6, N), device=dev))
    light_pdf = ls["choice_pdf"]
    v0 = _empty_vertex(N, dev)
    v0["pos"] = ls["pos"]
    v0["normal"] = ls["normal"]
    v0["snormal"] = ls["normal"]
    emission = ls["emission"] if spec_ctx is None else spec_ctx.light_power_sample(ls)
    v0["beta"] = emission / torch.clamp(light_pdf, min=1e-12)[None]
    v0["fpdf"] = light_pdf
    v0["wo"] = ls["direction"]
    v0["vtype"] = torch.full((N,), V_LIGHT, dtype=torch.int32, device=dev)
    v0["prim"] = ls["prim"]

    beta0 = v0["beta"] * torch.abs(pv.dot(ls["normal"], ls["direction"]))[None]
    if corrected:
        # the standard start beta_1 = Le cos0 / (pdf_area pdf_dir); the
        # reference never divides by the emission-direction pdf
        beta0 = beta0 / torch.clamp(ls["dir_pdf_std"], min=1e-6)[None]
    dir_pdf = ls["dir_pdf_std"] if corrected else ls["dir_pdf"]
    return ls["pos"], ls["direction"], beta0, dir_pdf, v0


def build_light_path(scene, N, key, light_depth: int = LIGHT_MAX_DEPTH,
                     corrected: bool = False, spec_ctx=None):
    """Returns (verts, count, overflow)."""
    k_sample, k_walk = rng.split(key)
    o, d, beta0, dir_pdf, v0 = _light_init(scene, N, k_sample, corrected, spec_ctx)
    return _walk(scene, o, d, beta0, dir_pdf, v0, light_depth, k_walk,
                 is_light_path=True, corrected=corrected, spec_ctx=spec_ctx)


def build_subpaths(scene, o, d, k_eye, k_light, eye_depth: int = EYE_MAX_DEPTH,
                   light_depth: int = LIGHT_MAX_DEPTH, fpdf0=None,
                   corrected: bool = False, walk_compaction=None,
                   return_overflow: bool = False, spec_ctx=None):
    """Eye + light subpaths with each depth's two walk traces fused into
    one wavefront (per-lane hits do not depend on the batch, so the
    result equals the separate builders' with the same keys).  Returns
    (eye, eye_count, light, light_count[, overflow]).

    walk_compaction: optional (eye_schedule, light_schedule), each the
    _walk contract; overflow counts live lanes dropped at capacity (a
    device scalar; 0 is the exact estimator)."""
    N = o.shape[1]
    dev = o.device
    sched_e, sched_l = walk_compaction or (None, None)
    sched_e, sched_l = dict(sched_e or ()), dict(sched_l or ())

    with metrics.span("bdpt.walk", side="eye", depth=0, width=N):
        if fpdf0 is None:
            fpdf0 = torch.ones((N,), dtype=torch.float32, device=dev)
        c = _channels(spec_ctx)
        st_e = _walk_state(o, d, torch.ones((c, N), dtype=torch.float32, device=dev), fpdf0,
                           _eye_vertex0(o, d, c), eye_depth, spec_ctx)
    with metrics.span("bdpt.walk", side="light", depth=0, width=N):
        k_sample, k_lwalk = rng.split(k_light)
        lo, ld, lbeta0, ldir_pdf, v0l = _light_init(scene, N, k_sample, corrected, spec_ctx)
        st_l = _walk_state(lo, ld, lbeta0, ldir_pdf, v0l, light_depth, spec_ctx)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)

    for depth in range(1, max(eye_depth, light_depth)):
        do_e = depth < eye_depth
        do_l = depth < light_depth
        # the fronts of this depth, fused into one wavefront for the trace
        with metrics.span("bdpt.walk", side="fused", depth=depth):
            if do_e and depth in sched_e:
                overflow = overflow + _compact_walk_front(st_e, _walk_width(N, sched_e[depth]),
                                                          "eye", depth)
            if do_l and depth in sched_l:
                overflow = overflow + _compact_walk_front(st_l, _walk_width(N, sched_l[depth]),
                                                          "light", depth)
            fronts = [(st, k, light_path) for st, k, light_path, on in
                      ((st_e, k_eye, False, do_e), (st_l, k_lwalk, True, do_l)) if on]
            o_t = [pv.where(st["alive"], st["o"], torch.full_like(st["o"], PARK))
                   for st, _, _ in fronts]
            o_cat = torch.cat(o_t, dim=1)
            d_cat = torch.cat([st["d"] for st, _, _ in fronts], dim=1)
        tt = trace_shaded(scene, o_cat, d_cat)
        start = 0
        for (st, k, light_path), o_f in zip(fronts, o_t):
            w = o_f.shape[1]
            with metrics.span("bdpt.walk", side="light" if light_path else "eye", depth=depth,
                              width=w):
                traced = tuple(x[..., start:start + w] for x in tt)
                _walk_step(scene, st, depth, k, light_path, corrected, o_f, traced, spec_ctx)
            start += w

    out = (st_e["verts"], st_e["count"], st_l["verts"], st_l["count"])
    return out + (overflow,) if return_overflow else out


# ----------------------------------------------------------- connections

def _remap0(f):
    return torch.where(f == 0.0, 1.0, f)


@metrics.spanned("bdpt.mis")
def _mis_weight(eye, light, e, l, ov):
    """1 / (1 + sum of pdf-ratio products).  `ov` carries the connection's
    endpoint overrides: eye_rpdf_e1, eye_rpdf_e2, light_rpdf_l1,
    light_rpdf_l2 (each (N,) or None) and, for l == 1, sample_fpdf0."""
    if e + l == 2:
        return torch.ones_like(eye[0]["fpdf"])

    def eye_rpdf(k):
        if k == e - 1 and ov.get("eye_rpdf_e1") is not None:
            return ov["eye_rpdf_e1"]
        if k == e - 2 and ov.get("eye_rpdf_e2") is not None:
            return ov["eye_rpdf_e2"]
        return eye[k]["rpdf"]

    def eye_delta(k):
        if k == e - 1:
            return torch.zeros_like(eye[k]["delta"])
        return eye[k]["delta"]

    def light_rpdf(k):
        if k == l - 1 and ov.get("light_rpdf_l1") is not None:
            return ov["light_rpdf_l1"]
        if k == l - 2 and ov.get("light_rpdf_l2") is not None:
            return ov["light_rpdf_l2"]
        return light[k]["rpdf"]

    def light_fpdf(k):
        if k == 0 and l == 1 and ov.get("sample_fpdf0") is not None:
            return ov["sample_fpdf0"]
        return light[k]["fpdf"]

    def light_delta(k):
        if k == l - 1 or (k == 0 and l == 1):
            return torch.zeros_like(light[k]["delta"])
        return light[k]["delta"]

    ws = 0.0
    w = 1.0
    for k in range(e - 1, 0, -1):
        w = w * _remap0(eye_rpdf(k)) / _remap0(eye[k]["fpdf"])
        nd = (eye_delta(k) == 0.0) & (eye_delta(k - 1) == 0.0)
        ws = ws + torch.where(nd, w, 0.0)

    w = 1.0
    for k in range(l - 1, -1, -1):
        w = w * _remap0(light_rpdf(k)) / _remap0(light_fpdf(k))
        if k == 0:
            nd = light_delta(0) == 0.0
        else:
            nd = (light_delta(k) == 0.0) & (light_delta(k - 1) == 0.0)
        ws = ws + torch.where(nd, w, 0.0)

    return 1.0 / (1.0 + ws)


def _light_origin_pdf(ev):
    """(1/area) of the emitter the eye path hit (the light count divides
    it at the call)."""
    return 1.0 / torch.clamp(ev["area"], min=1e-12)


def _cos_in(v):
    """|wo . n| folded into every stored vertex beta (the reference's
    convention); the corrected estimator divides it back out."""
    return torch.clamp(torch.abs(pv.dot(v["wo"], v["normal"])), min=1e-6)


def _active(eye_count, light_count, e, l):
    active = eye_count >= e
    return active & (light_count >= l) if l > 0 else active


def _project_light(spec, cam, lv, active):
    """The e = 1 strategies' camera projection of light vertex lv:
    (px, py, wi (3, N), ndl, sel before the visibility test)."""
    px, py, wi_rows, vis = project(spec, cam, lv["pos"].T)
    wi = wi_rows.T
    ndl = pv.dot(wi, lv["snormal"])
    sel = active & vis & (lv["delta"] != 1.0) & (ndl < 0.0) & (lv["vtype"] == V_SURFACE)
    return px, py, wi, ndl, sel


@metrics.spanned("bdpt.shadow_requests")
def _shadow_requests(scene, spec, cam, eye, eye_count, light, light_count, key, pairs):
    """Every l > 0 strategy's shadow ray (pass 1 of _connections): lists
    of (3, N) origins and directions, (N,) distance bounds, (N,) active
    masks, and the (e, l) tags.  Each ray carries its target distance as
    its bound (visibility is decided by `prim == target`, which a hit
    beyond it can never satisfy); parked lanes get 1e-3."""
    N = eye[0]["pos"].shape[1]
    dev = eye[0]["pos"].device
    req_o, req_d, req_tmax, req_sel, req_tags = [], [], [], [], []
    park = torch.full((3, N), PARK, dtype=torch.float32, device=dev)

    def bound(sel, dist):
        return torch.where(sel, dist * 1.001 + 1e-3, 1e-3)

    for e, l in pairs:
        if l == 0:
            continue
        ev = eye[e - 1]
        active = _active(eye_count, light_count, e, l)
        if e == 1:
            lv = light[l - 1]
            _, _, wi, _, sel = _project_light(spec, cam, lv, active)
            cam_o = cam.eye[:, None].expand(3, N)
            sh_o, sh_d = pv.where(sel, cam_o, park), wi
            tdist = pv.length(lv["pos"] - cam_o)
        elif l == 1:
            u3 = rng.uniform(rng.fold_in(key, e * 16 + l), (3, N), device=dev)
            surface = pv.offset_ray(ev["pos"], ev["snormal"])
            ls = sample_li(scene, surface, u3)
            sel = active & (ev["delta"] != 1.0) & (ev["vtype"] == V_SURFACE)
            sh_o, sh_d = pv.where(sel, surface, park), -ls["direction"]
            tdist = ls["dist"]
        else:
            lv = light[l - 1]
            sel = (active & (lv["delta"] != 1.0) & (ev["delta"] != 1.0)
                   & (ev["vtype"] == V_SURFACE) & (lv["vtype"] == V_SURFACE))
            dirv = ev["pos"] - lv["pos"]
            tdist = torch.clamp(pv.length(dirv), min=1e-6)
            dirv = dirv * (1.0 / tdist)[None]
            ndl_l = pv.dot(dirv, lv["snormal"])
            lv_from = pv.offset_ray(lv["pos"], lv["snormal"] * pv.sign_nonzero(ndl_l)[None])
            sh_o, sh_d = pv.where(sel, lv_from, park), dirv
        req_o.append(sh_o)
        req_d.append(sh_d)
        req_tmax.append(bound(sel, tdist))
        req_sel.append(sel)
        req_tags.append((e, l))
    return req_o, req_d, req_tmax, req_sel, req_tags


@metrics.spanned("bdpt.splat")
def _splat_add(flat, pixels, values):
    """flat (rows, 3) += values (n, 3) at row ids (n,), in place, as one
    deterministic scatter-add (see the module docstring)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        flat.index_put_((pixels,), values, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


@metrics.spanned("bdpt.connections")
def _connections(scene, spec, cam, eye, eye_count, light, light_count, key,
                 corrected: bool = False, max_depth: int = MAX_DEPTH,
                 unweighted: bool = False, shadow_cap=None, spec_ctx=None, strategies=None):
    """All (e, l) strategies -> (radiance (3, N), splat (W, H, 3), kills).

    spec_ctx: the frame's full-width spectral context (never a compacted
    front's): radiance is then the scalar power, still to be converted by
    the caller (`spec_ctx.to_rgb`), while the splat is converted here,
    lane by lane, before it lands on another pixel.  strategies: optional
    host predicate f(e, l) -> bool choosing the strategies to evaluate (a
    diagnostic hook of tools/bdpt_decompose.py).

    corrected=False keeps the reference's contribution formulas
    (connection BSDFs divided by their pdf, cosine-folded betas, no
    pinhole importance on the splat), which its goldens embody;
    corrected=True is the standard estimator.  unweighted: every MIS
    weight 1.  shadow_cap: None -> SHADOW_CAP; <= 0 -> no cap; else the
    fraction of the shadow batch the tracer runs on.  kills: active
    shadow lanes cut at that capacity (a device scalar; the reference
    reports none)."""
    N = eye[0]["pos"].shape[1]
    dev = eye[0]["pos"].device
    radiance = torch.zeros((_channels(spec_ctx), N), dtype=torch.float32, device=dev)
    n_lights = float(scene.n_lights)
    kills = torch.zeros((), dtype=torch.int64, device=dev)

    pairs = [
        (e, l)
        for e in range(1, len(eye) + 1)
        for l in range(0, len(light) + 1)
        if not ((l == 1 and e == 1) or l + e - 2 < 0 or l + e - 2 > max_depth)
        and (strategies is None or strategies(e, l))
    ]

    # pass 1: every strategy's shadow ray, bounded by its target distance,
    # traced as ONE wavefront (the tracer's fixed costs paid once)
    occ = {}
    req_o, req_d, req_tmax, req_sel, req_tags = _shadow_requests(
        scene, spec, cam, eye, eye_count, light, light_count, key, pairs)
    sc = SHADOW_CAP if shadow_cap is None else (shadow_cap if shadow_cap > 0 else None)
    if req_tags:
        sel_all = torch.cat(req_sel) if sc is not None else None
        t_all, prim_all = trace(scene, torch.cat(req_o, 1), torch.cat(req_d, 1),
                                tmax=torch.cat(req_tmax), active=sel_all, cap_frac=sc)
        cap = trace_capacity(scene, len(req_tags) * N, sc) if sc is not None else None
        if cap is not None:
            kills = torch.clamp(sel_all.sum() - cap, min=0)
        for i, tag in enumerate(req_tags):
            occ[tag] = (t_all[i * N:(i + 1) * N], prim_all[i * N:(i + 1) * N])

    splat_px, splat_val = [], []
    dump = spec.width * spec.height + torch.arange(N, device=dev) % SPLAT_DUMP
    for e, l in pairs:
        ev = eye[e - 1]
        active = _active(eye_count, light_count, e, l)
        ov = {}

        if l == 0:
            # the eye path hit the light directly
            sel = active & (ev["vtype"] == V_LIGHT)
            beta_e = ev["beta"] / _cos_in(ev)[None] if corrected else ev["beta"]
            contrib = torch.where(sel[None], beta_e, 0.0)
            ov["eye_rpdf_e1"] = _light_origin_pdf(ev) / n_lights
            if e > 1:
                em = eye[e - 2]
                to = em["pos"] - ev["pos"]
                dist = torch.clamp(pv.length(to), min=1e-6)
                to = to * (1.0 / dist)[None]
                ldn = pv.dot(to, ev["normal"])
                if corrected:
                    # cos/pi at the light (no floor), area conversion with
                    # the cosine at the destination
                    cos_dst = torch.where(em["vtype"] == V_SURFACE,
                                          torch.abs(pv.dot(to, em["snormal"])), 1.0)
                    ov["eye_rpdf_e2"] = torch.abs(ldn) / C.PI * cos_dst / (dist * dist)
                else:
                    # the reference: floored pdf x cosine at the source
                    ov["eye_rpdf_e2"] = torch.abs(_cos_pdf(torch.abs(ldn)) * ldn) / (dist * dist)

        elif e == 1:
            # light tracing: project the light vertex into the camera
            lv = light[l - 1]
            px, py, wi, ndl, sel = _project_light(spec, cam, lv, active)
            cam_o = cam.eye[:, None].expand(3, N)
            _, sh_prim = occ[(e, l)]
            sel = sel & (sh_prim == lv["prim"])
            brdf, pdf = _evaluate_pdf(lv["snormal"], -lv["wo"], -wi, lv["metallic"],
                                      lv["roughness"], true_pdf=corrected)
            tdist = torch.clamp(pv.length(lv["pos"] - cam_o), min=1e-6)
            g = torch.abs(ndl) / (tdist * tdist)
            sel = sel & (pdf > 0.0)
            if corrected:
                # pinhole importance fx*fy/cos^2 (G's lens cosine folded
                # in) and 1/N for the N light subpaths of the frame
                axis_w = cam.view[2, :3]
                cos_t = torch.abs(pv.dot(-wi, axis_w[:, None].expand(3, N)))
                cos_t = torch.clamp(cos_t, min=1e-3)
                we = spec.fx * spec.fy / (cos_t * cos_t * float(N))
                contrib = torch.where(sel[None], (g * we * brdf)[None]
                                      * (lv["beta"] / _cos_in(lv)[None]) * lv["reflect"], 0.0)
            else:
                contrib = torch.where(sel[None], (g * brdf / torch.clamp(pdf, min=1e-12))[None]
                                      * lv["beta"] * lv["reflect"], 0.0)
            # overrides (the sample vertex is the lens; eye[0] equals it)
            to = eye[0]["pos"] - lv["pos"]
            dist = torch.clamp(pv.length(to), min=1e-6)
            to = to * (1.0 / dist)[None]
            axis = cam.view[2, :3]
            ldn = pv.dot(to, axis[:, None].expand(3, N))
            if corrected:
                # pinhole direction pdf to area measure with lv's cosine
                cos_t = torch.clamp(torch.abs(ldn), min=1e-3)
                ov["light_rpdf_l1"] = (spec.fx * spec.fy / (cos_t * cos_t * cos_t)
                                       * torch.abs(pv.dot(to, lv["snormal"])) / (dist * dist))
            else:
                ov["light_rpdf_l1"] = ldn / (dist * dist)
            if l >= 2:
                lm = light[l - 2]
                wi2 = ev["pos"] - lv["pos"]
                wo2 = lm["pos"] - lv["pos"]
                dist2 = torch.clamp(pv.length(wo2), min=1e-6)
                wi2 = pv.normalize(wi2)
                wo2 = pv.normalize(wo2)
                if corrected:
                    pdf2 = _disney_pdf(lv["snormal"], wi2, wo2, lv["metallic"],
                                       lv["roughness"], true_pdf=True)
                    cos_dst = torch.where(lm["vtype"] == V_NONE, 1.0,
                                          torch.abs(pv.dot(lm["normal"], wo2)))
                    ov["light_rpdf_l2"] = pdf2 * cos_dst / (dist2 * dist2)
                else:
                    pdf2 = torch.where(_quirk_is_disney(lv),
                                       _disney_pdf(lv["normal"], wi2, wo2, lv["metallic"],
                                                   lv["roughness"]), 1.0)
                    geo = pdf2 / (dist2 * dist2)
                    ov["light_rpdf_l2"] = geo * torch.where(
                        lm["vtype"] == V_SURFACE, torch.abs(pv.dot(lv["normal"], wo2)), 1.0)
            mw = torch.ones((N,), dtype=torch.float32, device=dev) if unweighted \
                else _mis_weight(eye, light, e, l, ov)
            val = contrib * mw[None]
            if spec_ctx is not None:
                val = spec_ctx.to_rgb(val)
            val = val.T  # (N, 3)
            pxc = torch.clamp(px, 0, spec.width - 1).to(torch.int64)
            pyc = torch.clamp(py, 0, spec.height - 1).to(torch.int64)
            splat_px.append(torch.where(sel, pxc * spec.height + pyc, dump))
            splat_val.append(val)
            continue

        elif l == 1:
            # NEE from the eye vertex with a fresh light sample
            u3 = rng.uniform(rng.fold_in(key, e * 16 + l), (3, N), device=dev)
            surface = pv.offset_ray(ev["pos"], ev["snormal"])
            ls = sample_li(scene, surface, u3)
            wi = ls["direction"]
            ndl_l = pv.dot(wi, ls["normal"])
            ndl_e = pv.dot(wi, ev["snormal"])
            sel = active & (ev["delta"] != 1.0) & (ev["vtype"] == V_SURFACE)
            t_sh, sh_prim = occ[(e, l)]
            sel = sel & (sh_prim == ls["prim"]) & (t_sh > C.EPS)
            brdf, pdf = _evaluate_pdf(ev["snormal"], -ev["wo"], -wi, ev["metallic"],
                                      ev["roughness"], true_pdf=corrected)
            sel = sel & (pdf > 0.0)
            g = torch.abs(ndl_e * ndl_l) / torch.clamp(t_sh * t_sh, min=1e-12)
            beta_e = ev["beta"] / _cos_in(ev)[None] if corrected else ev["beta"]
            brdf_term = brdf if corrected else brdf / torch.clamp(pdf, min=1e-12)
            emission = ls["emission"] if spec_ctx is None else spec_ctx.light_power_sample(ls)
            contrib = torch.where(
                sel[None],
                g[None] * beta_e * brdf_term[None] * ev["reflect"] * emission
                / torch.clamp(ls["choice_pdf"], min=1e-12)[None],
                0.0)
            # overrides: the sampled light is light vertex 0 now
            to = ev["pos"] - ls["pos"]
            dist = torch.clamp(pv.length(to), min=1e-6)
            to = to * (1.0 / dist)[None]
            ldn = torch.abs(pv.dot(to, ls["normal"]))
            ov["sample_fpdf0"] = ls["choice_pdf"]
            if corrected:
                # emission pdf cos/pi (no floor) x the eye vertex's cosine
                ov["eye_rpdf_e1"] = (ldn / C.PI * torch.abs(pv.dot(to, ev["snormal"]))
                                     / (dist * dist))
            else:
                ov["eye_rpdf_e1"] = _cos_pdf(ldn) * ldn / (dist * dist)
            # light.rpdf[0] (the sample) from the eye vertex; e == 1 never
            # reaches this branch
            wi2 = pv.normalize(eye[e - 2]["pos"] - ev["pos"])
            wo2 = ls["pos"] - ev["pos"]
            dist2 = torch.clamp(pv.length(wo2), min=1e-6)
            wo2 = pv.normalize(wo2)
            if corrected:
                pdf2 = _disney_pdf(ev["snormal"], wi2, wo2, ev["metallic"], ev["roughness"],
                                   true_pdf=True)
                ov["light_rpdf_l1"] = (pdf2 * torch.abs(pv.dot(ls["normal"], wo2))
                                       / (dist2 * dist2))
            else:
                pdf2 = torch.where(_quirk_is_disney(ev),
                                   _disney_pdf(ev["snormal"], wi2, wo2, ev["metallic"],
                                               ev["roughness"]), 1.0)
                ov["light_rpdf_l1"] = (pdf2 * torch.abs(pv.dot(ev["normal"], wo2))
                                       / (dist2 * dist2))
            # eye.rpdf[e-2] from the sampled light through ev
            wi3 = pv.normalize(ls["pos"] - ev["pos"])
            wo3 = eye[e - 2]["pos"] - ev["pos"]
            dist3 = torch.clamp(pv.length(wo3), min=1e-6)
            wo3 = pv.normalize(wo3)
            pdf3 = _disney_pdf(ev["snormal"], wi3, wo3, ev["metallic"], ev["roughness"],
                               true_pdf=corrected)
            r = pdf3 / (dist3 * dist3)
            cos_n = eye[e - 2]["snormal"] if corrected else ev["normal"]
            r = r * torch.where(eye[e - 2]["vtype"] == V_SURFACE,
                                torch.abs(pv.dot(cos_n, wo3)), 1.0)
            ov["eye_rpdf_e2"] = torch.where(ev["vtype"] == V_SURFACE, r, 1.0)

        else:
            # surface-surface connection
            lv = light[l - 1]
            sel = (active & (lv["delta"] != 1.0) & (ev["delta"] != 1.0)
                   & (ev["vtype"] == V_SURFACE) & (lv["vtype"] == V_SURFACE))
            dirv = ev["pos"] - lv["pos"]
            dist = torch.clamp(pv.length(dirv), min=1e-6)
            dirv = dirv * (1.0 / dist)[None]
            ndl_l = pv.dot(dirv, lv["snormal"])
            ndl_e = pv.dot(dirv, ev["snormal"])
            t_sh, sh_prim = occ[(e, l)]
            sel = sel & (sh_prim == ev["prim"]) & (t_sh > C.EPS)
            brdf_l, pdf_l = _evaluate_pdf(lv["snormal"], -lv["wo"], dirv, lv["metallic"],
                                          lv["roughness"], true_pdf=corrected)
            brdf_e, pdf_e = _evaluate_pdf(ev["snormal"], -ev["wo"], -dirv, ev["metallic"],
                                          ev["roughness"], true_pdf=corrected)
            sel = sel & (brdf_l > 0.0) & (brdf_e > 0.0)
            g = torch.abs(ndl_e * ndl_l) / (dist * dist)
            if corrected:
                beta_e, beta_l = ev["beta"] / _cos_in(ev)[None], lv["beta"] / _cos_in(lv)[None]
                f_l, f_e = brdf_l, brdf_e
            else:
                beta_e, beta_l = ev["beta"], lv["beta"]
                f_l = brdf_l / torch.clamp(pdf_l, min=1e-12)
                f_e = brdf_e / torch.clamp(pdf_e, min=1e-12)
            contrib = torch.where(sel[None], g[None] * beta_e * beta_l * f_l[None] * f_e[None]
                                  * ev["reflect"] * lv["reflect"], 0.0)
            # eye.rpdf[e-1]: from light[l-1] toward ev
            wi2 = light[l - 2]["pos"] - lv["pos"] if l > 1 else -lv["wo"]
            wo2 = ev["pos"] - lv["pos"]
            dist2 = torch.clamp(pv.length(wo2), min=1e-6)
            wi2n = pv.normalize(wi2)
            wo2n = pv.normalize(wo2)
            if corrected:
                pdf2 = _disney_pdf(lv["snormal"], wi2n, wo2n, lv["metallic"], lv["roughness"],
                                   true_pdf=True)
                ov["eye_rpdf_e1"] = (pdf2 * torch.abs(pv.dot(ev["snormal"], wo2n))
                                     / (dist2 * dist2))
            else:
                pdf2 = torch.where(_quirk_is_disney(lv),
                                   _disney_pdf(lv["snormal"], wi2n, wo2n, lv["metallic"],
                                               lv["roughness"]), 1.0)
                ov["eye_rpdf_e1"] = (pdf2 * torch.abs(pv.dot(lv["normal"], wo2n))
                                     / (dist2 * dist2))
            if e > 1:
                # light.rpdf[l-1]: from ev toward light[l-1]
                wi3 = pv.normalize(eye[e - 2]["pos"] - ev["pos"])
                wo3 = lv["pos"] - ev["pos"]
                dist3 = torch.clamp(pv.length(wo3), min=1e-6)
                wo3 = pv.normalize(wo3)
                if corrected:
                    pdf3 = _disney_pdf(ev["snormal"], wi3, wo3, ev["metallic"],
                                       ev["roughness"], true_pdf=True)
                    r3 = pdf3 * torch.abs(pv.dot(lv["snormal"], wo3)) / (dist3 * dist3)
                else:
                    pdf3 = torch.where(_quirk_is_disney(ev),
                                       _disney_pdf(ev["snormal"], wi3, wo3, ev["metallic"],
                                                   ev["roughness"]), 1.0)
                    r3 = pdf3 * torch.abs(pv.dot(ev["normal"], wo3)) / (dist3 * dist3)
                ov["light_rpdf_l1"] = torch.where(ev["vtype"] == V_SURFACE, r3, 1.0)
                # eye.rpdf[e-2]: through ev toward eye[e-2]
                wi4 = pv.normalize(lv["pos"] - ev["pos"])
                wo4 = eye[e - 2]["pos"] - ev["pos"]
                dist4 = torch.clamp(pv.length(wo4), min=1e-6)
                wo4 = pv.normalize(wo4)
                pdf4 = _disney_pdf(ev["snormal"], wi4, wo4, ev["metallic"], ev["roughness"],
                                   true_pdf=corrected)
                r4 = pdf4 / (dist4 * dist4)
                cos_n = eye[e - 2]["snormal"] if corrected else ev["normal"]
                r4 = r4 * torch.where(eye[e - 2]["vtype"] == V_SURFACE,
                                      torch.abs(pv.dot(cos_n, wo4)), 1.0)
                ov["eye_rpdf_e2"] = torch.where(ev["vtype"] == V_SURFACE, r4, 1.0)
            if l > 1:
                # light.rpdf[l-2]: through light[l-1] toward light[l-2]
                lm = light[l - 2]
                wi5 = pv.normalize(ev["pos"] - lv["pos"])
                wo5 = lm["pos"] - lv["pos"]
                dist5 = torch.clamp(pv.length(wo5), min=1e-6)
                wo5 = pv.normalize(wo5)
                if corrected:
                    pdf5 = _disney_pdf(lv["snormal"], wi5, wo5, lv["metallic"],
                                       lv["roughness"], true_pdf=True)
                    r5 = pdf5 / (dist5 * dist5)
                    r5 = r5 * torch.where(lm["vtype"] == V_NONE, 1.0,
                                          torch.abs(pv.dot(lm["normal"], wo5)))
                else:
                    pdf5 = torch.where(_quirk_is_disney(lv),
                                       _disney_pdf(lv["normal"], wi5, wo5, lv["metallic"],
                                                   lv["roughness"]), 1.0)
                    r5 = pdf5 / (dist5 * dist5)
                    r5 = r5 * torch.where(lm["vtype"] == V_SURFACE,
                                          torch.abs(pv.dot(lv["normal"], wo5)), 1.0)
                ov["light_rpdf_l2"] = torch.where(ev["vtype"] != V_LIGHT, r5, 1.0)

        # the MIS weight applies when every channel is positive
        pos_all = (contrib > 0.0).all(dim=0)
        mw = torch.ones((N,), dtype=torch.float32, device=dev) if unweighted \
            else _mis_weight(eye, light, e, l, ov)
        radiance = radiance + contrib * torch.where(pos_all, mw, 1.0)[None]

    n_pix = spec.width * spec.height
    splat = torch.zeros((n_pix + SPLAT_DUMP, 3), dtype=torch.float32, device=dev)
    if splat_px:
        _splat_add(splat, torch.cat(splat_px), torch.cat(splat_val))
    splat = splat[:n_pix].reshape(spec.width, spec.height, 3)
    return radiance, splat, kills


# ---------------------------------------------------------------- renders

def render_paths(scene, spec: CameraSpec, cam, frame, key, corrected: bool = False,
                 max_depth: int = MAX_DEPTH, walk_compaction=None, shadow_cap=None,
                 return_overflow: bool = False, spec_ctx=None):
    """One frame's subpaths + connections -> (W, H, 3) radiance (and the
    overflow, a device scalar, with return_overflow).  max_depth caps the
    strategy depth; the walks run max_depth + 2 (eye) and + 1 (light)
    vertices.  spec_ctx: the frame's spectral context (bdpt_spec)."""
    with metrics.span("bdpt.camera"):
        k_eye, k_light, k_conn = rng.split(key, 3)
        k_cam, k_ewalk = rng.split(k_eye)
        o, d = _camera_rays(spec, cam, frame, k_cam)
        fpdf0 = _camera_dir_pdf(spec, cam, d) if corrected else None
    eye, eye_count, light, light_count, overflow = build_subpaths(
        scene, o, d, k_ewalk, k_light, eye_depth=max_depth + 2, light_depth=max_depth + 1,
        fpdf0=fpdf0, corrected=corrected, walk_compaction=walk_compaction,
        return_overflow=True, spec_ctx=spec_ctx)
    radiance, splat, kills = _connections(
        scene, spec, cam, eye, eye_count, light, light_count, k_conn, corrected=corrected,
        max_depth=max_depth, shadow_cap=shadow_cap, spec_ctx=spec_ctx)
    if spec_ctx is not None:
        radiance = spec_ctx.to_rgb(radiance)
    img = radiance.T.reshape(spec.width, spec.height, 3) + splat
    return (img, overflow + kills) if return_overflow else img


def render_frame(scene, spec: CameraSpec, cam, frame, key, corrected: bool = False,
                 max_depth: int = MAX_DEPTH, walk_compaction=None,
                 return_overflow: bool = False):
    """One progressive BDPT frame -> (W, H, 3) radiance."""
    return render_paths(scene, spec, cam, frame, key, corrected=corrected,
                        max_depth=max_depth, walk_compaction=walk_compaction,
                        return_overflow=return_overflow)


def _render_slice(scene, spec, cam, o, d, keys, slice_i: int, max_depth: int,
                  shadow_cap, walk_compaction):
    """Slice slice_i of a sliced frame: its lanes' subpaths and
    connections -> ((n, 3) radiance, (W, H, 3) splat, overflow)."""
    _, k_eye, k_light, k_conn = keys
    eye, eye_count, light, light_count, overflow = build_subpaths(
        scene, o, d, rng.fold_in(k_eye, slice_i), rng.fold_in(k_light, slice_i),
        eye_depth=max_depth + 2, light_depth=max_depth + 1,
        walk_compaction=walk_compaction, return_overflow=True)
    radiance, splat, kills = _connections(
        scene, spec, cam, eye, eye_count, light, light_count, rng.fold_in(k_conn, slice_i),
        max_depth=max_depth, shadow_cap=shadow_cap)
    return radiance.T, splat, overflow + kills


def render_frame_sliced(scene, spec: CameraSpec, cam, frame, key, n_slices: int = 2,
                        max_depth: int = MAX_DEPTH, shadow_cap=None, walk_compaction=None,
                        return_overflow: bool = False):
    """A BDPT frame rendered in `n_slices` sequential lane slices, each
    running the whole pipeline on 1/n of the pixels (its splats land on
    the full film), to bound the vertex pools' memory.  The keys are the
    reference's: split(key, 4), each folded with the slice index."""
    N = spec.width * spec.height
    ns = N // n_slices
    with metrics.span("bdpt.camera"):
        keys = rng.split(key, 4)
        o_full, d_full = _camera_rays(spec, cam, frame, keys[0])
        parts = []
        splat_total = torch.zeros((spec.width, spec.height, 3), dtype=torch.float32,
                                  device=d_full.device)
        overflow_total = torch.zeros((), dtype=torch.int64, device=d_full.device)
    for i in range(n_slices):
        with metrics.span("bdpt.slice", slice=i, width=ns):
            sl = slice(i * ns, (i + 1) * ns)
            rad, splat, ov = _render_slice(scene, spec, cam, o_full[:, sl], d_full[:, sl], keys,
                                           i, max_depth, shadow_cap, walk_compaction)
            parts.append(rad)
            splat_total = splat_total + splat
            overflow_total = overflow_total + ov
    with metrics.span("bdpt.splat"):
        img = torch.cat(parts, dim=0).reshape(spec.width, spec.height, 3) + splat_total
    return (img, overflow_total) if return_overflow else img


_sliced = None  # sliced_frame's frame function of the settings it bound last


def sliced_frame(n_slices: int = 2, max_depth: int = MAX_DEPTH, shadow_cap=None,
                 walk_compaction=None):
    """render_frame_sliced bound to these settings: a frame function of
    frame_graph.  The settings of the last call give the same function
    back, which keeps its FrameGraph across film calls; new settings bind
    a new one and let the old one and its graph go."""
    global _sliced
    settings = dict(n_slices=n_slices, max_depth=max_depth, shadow_cap=shadow_cap,
                    walk_compaction=walk_compaction)
    if _sliced is None or _sliced.keywords != settings:
        _sliced = functools.partial(render_frame_sliced, **settings)
    return _sliced


def render_film_frames(scene, spec: CameraSpec, cam, film, n_frames: int = 4,
                       n_slices: int = 2, max_depth: int = MAX_DEPTH, walk_compaction=None,
                       shadow_cap=None):
    """n progressive frames, each rendered by render_frame_sliced from the
    film's frame index and key, then accumulated (the reference CLI's
    batch loop).  Returns (film', overflow as an int: one host sync).  On
    a card, frames of index > 0 replay one CUDA graph of the sliced frame
    while no span records (frame_graph.render_film_frames)."""
    return frame_graph.render_film_frames(
        scene, spec, cam, film, sliced_frame(n_slices, max_depth, shadow_cap, walk_compaction),
        n_frames)
