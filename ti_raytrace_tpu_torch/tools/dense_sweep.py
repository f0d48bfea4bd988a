"""The dense sweep on the card, and the five paths that ride on it.

    python -m ti_raytrace_tpu_torch.tools.dense_sweep [--reps 5] [--frames 4]
        [--out dense.json]

Part 1, dense against cluster.  Records, at `ops.dense_trace.trace_shaded`,
the camera wavefront (512^2 lanes) and the merged bounce-1 wavefront
(16 x 65,536 lanes) of one single_model group, then traces each with the
dense tracer (its kernel, csrc/dense_trace.cu) and, called directly, with
the cluster tracer on the same scene's cluster tables; reports how far the
two agree (misses, t, prim), whether the dense kernel equals the plain
sweep `_sweep` bit for bit, and, from CUDA events after a warm-up, the
dense tracer's time (its table and gathers included), the dense kernel's
alone, the plain sweep's, the cluster tracer's (its sort and gathers
included) and the cluster kernel's alone.  Beside the dense kernel's time
stands the bound of the work it did (`bound_ms`, `work_counts`): its
(warp, group) pairs tested, from the kernel's own counts, the slab tests
and grazing guards it ran and the sphere tail, each part at its
instructions in the kernel's SASS (tools/sass.py) on the pipes that run
them (`pipe_bound_ms`).  Two bounds of the brute-force work the kernel no
longer does stand as context: lanes x prims x 60 operations at the FP32
peak (`sweep_bound_ms`, PR 10's), and lanes x prims triangle tests at
their SASS count on the pipes (`brute_issue_ms`).  sphere.obj holds each of its 760 triangles three
times, so most hits are exact t-ties between coincident copies, where the
dense sweep reports the lowest index and the cluster tracer the first in
its sweep order: differing prims are counted in all and apart from such
copies.  The same for the two largest wavefronts of one prism_rainbow
frame (spectral BDPT, unsliced), recorded at the integrator's calls of the
tracer: the fused depth-1 eye + light walk (2 x 512^2 lanes) and the
shadow batch of all 20 strategies packed to its capacity (0.09 of 20 x
512^2 lanes, as `trace_planar_capped` packs it), which carries a per-lane
`tmax`: the cluster tracer honours it and the dense sweep ignores it, so
that wavefront is compared by what its caller reads, the hits within the
bound.

Part 2, the paths.  For cornell_box, single_model, sky_dome, spectral_box
and prism_rainbow at 512^2, rendered as the CLI renders them
(`render_frames`): host ms/frame over `--frames` frames (single_model:
whole groups of 16) after a warm-up, the overflow kills, the peak device
memory, and from torch.profiler over one more call (one frame of BDPT)
the device ms/frame and the share of it spent in the sweeps (the dense
kernel's launches and the kernels of the torch calls inside the
`dense_trace._sweep` span), with the dense kernel's
launches per frame counted from those spans.  prism_rainbow is also rendered uncapped (the shadow
cap's effect) and, with `cluster_tracer()`, a switch local to this tool,
through the cluster tracer.  chip_smoke.py uses the recorders, the
comparison and `render_frames`.  Needs a CUDA card.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.ops import dense_trace as dt
from ti_raytrace_tpu_torch.tools import sass
from ti_raytrace_tpu_torch.tools.kernel_wavefronts import PEAK_FP32, SM_COUNT, time_ms

SIZE = 512
SCENES = ("cornell_box", "single_model", "sky_dome", "spectral_box", "prism_rainbow")
SWEEP_RANGE = "dense_trace._sweep"  # the span (profiler range) of ops/dense_trace.py
DENSE_KERNEL_NAME = "dense_sweep_kernel"  # the kernel of csrc/dense_trace.cu
MT_OPS = 60  # FP32 operations of one ray-triangle test (tools/kernel_wavefronts.py)
T_RTOL = 1e-5


def sweep_bound_ms(lanes: int, prims: int) -> float:
    """The least time the card could take for the brute-force sweep's
    arithmetic: every lane against every prim, MT_OPS operations each, at
    the FP32 peak.  (The bytes, rays in and hits out once, are far below
    it.)"""
    return lanes * prims * MT_OPS / PEAK_FP32 * 1e3


def max_sm_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout
    return float(out.strip().splitlines()[0])


def pipe_bound_ms(counts: dict, sm_mhz: float) -> float:
    """Instructions `counts` (by pipe, tools/sass.py) at the least clocks
    their pipes and the issue rate allow (`sass.clocks`) on each of
    SM_COUNT SMs at `sm_mhz`.  Under -fmad=false no product fuses with a
    sum, so the FP32 peak, which counts a fused multiply-add as two, is
    out of reach."""
    return sass.clocks(counts) / (SM_COUNT * sm_mhz * 1e6) * 1e3


def work_counts(lanes: int, groups: int, tail: int, tested_rows: int, guarded: int,
                looped_rows: int, parts: dict) -> dict:
    """Instructions by pipe of the work the kernel did on a wavefront, from
    its parts' SASS counts (`parts`, `sass.dense_counts()`) and its own
    counts: each lane's set-up, the triangle rows of the (warp, group)
    pairs it tested (32 lanes each), a slab test per (lane, group), the
    grazing guard's threshold on the pairs whose box no lane reached (32
    lanes each) and its test per row where its loop ran, and every lane
    against the sphere tail."""
    runs = {"lane": lanes, "triangle": tested_rows * 32, "slab": lanes * groups,
            "guard": guarded * 32, "graze": looped_rows * 32, "sphere": lanes * tail}
    return {pipe: sum(n * parts[part][pipe] for part, n in runs.items())
            for pipe in parts["triangle"]}


@contextlib.contextmanager
def recording():
    """Record the rays (o, d) of every dense `trace_shaded` call in the
    block, in call order."""
    calls = []
    real = dt.trace_shaded

    def rec(scene, o, d):
        calls.append((o, d))
        return real(scene, o, d)

    dt.trace_shaded = rec
    try:
        yield calls
    finally:
        dt.trace_shaded = real


def render_frames(scene, cfg, spec, cam, fl, n_frames: int, sdata=None):
    """n frames into the film as the CLI renders the scene
    (`examples.run.render_batch` with the config's integrator and group).
    Returns (film', overflow kills)."""
    from ti_raytrace_tpu_torch.examples.run import render_batch

    return render_batch(scene, cfg, spec, cam, fl, n_frames, cfg.integrator,
                        cfg.group or 0, sdata)


def group_wavefronts(scene, cfg, spec, cam, fl):
    """One merged group of single_model into `fl`, recorded: ((name, o, d,
    shared origin or None) of a camera wavefront and of the first merged
    bounce-1 wavefront, film', overflow kills).  The camera wavefront is
    the group's second: a film's frame 0 has no pixel jitter, and its
    regular grid sends rays exactly through mesh edges in the sphere's
    symmetry plane, where neighbouring triangles tie."""
    with recording() as calls:
        fl, kills = render_frames(scene, cfg, spec, cam, fl, cfg.group)
    n = spec.width * spec.height
    o, d = [c for c in calls if c[0].shape[1] == n][1]
    deep = next(c for c in calls if c[0].shape[1] > n)
    waves = [("camera", o, d, o[:, 0].contiguous()),
             ("merged bounce 1", deep[0], deep[1], None)]
    return waves, fl, kills


@contextlib.contextmanager
def cluster_tracer():
    """Send every scene to the cluster tracer inside the block, whatever
    its primitive count (every scene carries its cluster tables): a switch
    for measurements, local to this tool."""
    import ti_raytrace_tpu_torch.accel as accel

    real = accel.DENSE_MAX_PRIMS
    accel.DENSE_MAX_PRIMS = 0
    try:
        yield
    finally:
        accel.DENSE_MAX_PRIMS = real


def prism_wavefronts(scene, cfg, spec, cam, frame: int = 1, seed: int = 2):
    """The two largest wavefronts of one unsliced prism_rainbow frame,
    recorded at bdpt_rgb's calls of the tracer: [(name, o, d, tmax or
    None)] of the fused depth-1 walk and of the shadow batch packed to its
    capacity (alive first, as `trace_planar_capped` packs it), and the
    number of active lanes in that prefix."""
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.examples.run import spectral_data
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    walks, shadows = [], []
    real_shaded, real_trace = bdpt_rgb.trace_shaded, bdpt_rgb.trace

    def rec_shaded(sc, o, d, *a, **kw):
        walks.append((o, d))
        return real_shaded(sc, o, d, *a, **kw)

    def rec_trace(sc, o, d, *a, **kw):
        shadows.append((o, d, kw["tmax"], kw["active"], kw["cap_frac"]))
        return real_trace(sc, o, d, *a, **kw)

    bdpt_rgb.trace_shaded, bdpt_rgb.trace = rec_shaded, rec_trace
    try:
        spectral_data(cfg, cfg.integrator, scene.device)(scene, spec, cam, frame,
                                                         rng.PRNGKey(seed))
    finally:
        bdpt_rgb.trace_shaded, bdpt_rgb.trace = real_shaded, real_trace
    o, d, tmax, active, cap_frac = shadows[0]
    sel = torch.sort((~active).to(torch.int64), stable=True).indices[
        :dt.capacity_lanes(o.shape[1], cap_frac)]
    packed = (o.index_select(1, sel), d.index_select(1, sel), tmax.index_select(0, sel))
    return ([("fused depth-1 walk", walks[0][0], walks[0][1], None),
             ("capped shadow batch (tmax)",) + packed],
            int(active.index_select(0, sel).sum()))


def kernel_vs_plain(scene, o, d, reps: int, sm_mhz: float) -> dict:
    """The dense kernel against the plain sweep `_sweep` on one wavefront,
    both on the card: bit-equality of t and of prim (`bit_equal`), the
    largest |dt| on the lanes either calls a hit (`max_abs_err`), the
    kernel's time over `reps` launches after a warm-up (`kernel_ms`), the
    plain sweep's over one call after a warm-up (`plain_ms`); the (warp,
    group) pairs one more launch tested, guarded and looped over the rows
    in its guard (`tested`, `guarded`, `looped`, of `pairs`), the rows of
    the tested and the looped pairs (`tested_rows`, `looped_rows`) and the
    share of pairs culled; the bound of the work done (`bound_ms`, by
    operations, its instructions by pipe in `work_instructions`) and, for
    context, the brute-force work's at the FP32 peak (`brute_peak_ms`) and
    at its SASS count (`brute_issue_ms`), each with the kernel's share of
    it."""
    boxes, rows = scene.dense_boxes, scene.dense_rows
    o, d = o.contiguous(), d.contiguous()  # as trace_planar hands them to the kernel
    ms_kernel, (t_k, p_k) = time_ms(lambda: dt.DENSE_KERNEL(o, d, boxes, rows), reps)
    counts = torch.zeros(5, dtype=torch.int32, device=o.device)
    dt.DENSE_KERNEL(o, d, boxes, rows, counts)
    tested, guarded, looped, tested_rows, looped_rows = counts.tolist()
    ms_plain, (t_p, p_p) = time_ms(lambda: dt._sweep(scene, o, d), 1)
    hit = (p_k >= 0) | (p_p >= 0)
    n, groups = o.shape[1], boxes.shape[0]
    tail = rows.shape[0] - dt.GROUP * groups
    pairs = -(-n // 256) * 8 * groups  # the launch's warps x groups
    parts = sass.dense_counts()
    peak = sweep_bound_ms(n, scene.n_prims)
    brute = pipe_bound_ms({k: n * scene.n_prims * v for k, v in parts["triangle"].items()},
                          sm_mhz)
    work = work_counts(n, groups, tail, tested_rows, guarded, looped_rows, parts)
    bound = pipe_bound_ms(work, sm_mhz)
    return dict(bit_equal=torch.equal(t_k, t_p) and torch.equal(p_k, p_p),
                max_abs_err=float(torch.where(hit, (t_k - t_p).abs(), 0.0).max())
                if n else 0.0,
                kernel_ms=ms_kernel, plain_ms=ms_plain, bound_ms=bound, bound_by="operations",
                share=bound / ms_kernel, work_instructions=work, brute_peak_ms=peak,
                brute_peak_share=peak / ms_kernel, brute_issue_ms=brute,
                brute_issue_share=brute / ms_kernel, tested=tested, tested_rows=tested_rows,
                looped_rows=looped_rows,
                guarded=guarded, looped=looped, pairs=pairs,
                culled_frac=1.0 - tested / max(pairs, 1),
                sm_mhz=sm_mhz)


def compare(scene, o, d, shared_origin, reps: int, sm_mhz: float, tmax=None) -> dict:
    """The dense tracer and the cluster tracer on one wavefront of a scene
    that has both tables: agreement and times, with `kernel_vs_plain`'s
    figures.  The camera wavefront goes to the cluster tracer as the path
    tracer would send it (shared origin, unsorted), any other through its
    sorted mode.  tmax: the wavefront's per-lane bound, which only the
    cluster tracer takes; the hits compared are then the dense sweep's
    within the bound (those its caller reads), and a lane whose hit lies
    within T_RTOL of its bound may fall on either side (`at_bound`,
    counted)."""
    from ti_raytrace_tpu_torch.ops import cluster_trace as ct

    if shared_origin is not None:
        kw = dict(sort_rays=False, shared_origin=shared_origin)
    else:
        kw = dict(sort_rays=True, sort_small=True)
    ms_dense, (t_d, p_d, _, _) = time_ms(lambda: dt.trace_shaded(scene, o, d), reps)
    ms_cluster, (t_c, p_c, _, _) = time_ms(
        lambda: ct.trace_clustered(scene, o, d, want_attr=True, tmax=tmax, **kw), reps)
    args, _ = ct.kernel_inputs(scene, o, d, kw["sort_rays"], shared_origin, tmax=tmax)
    ms_kernel, _ = time_ms(lambda: ct.KERNEL(*args), reps)
    at_bound = 0
    if tmax is not None:
        near = (p_d >= 0) & ((t_d - tmax).abs() <= T_RTOL * tmax)
        at_bound = int(near.sum())
        beyond = (t_d >= tmax) | near
        p_d = torch.where(beyond, -1, p_d)
        p_c = torch.where(near, -1, p_c)
    hit = p_d >= 0
    n_hit = int(hit.sum())
    dt_abs = torch.where(hit & (p_c >= 0), (t_c - t_d).abs(), 0.0)
    mism = hit & (p_c >= 0) & (p_c != p_d)
    # differing prims that are not copies of one triangle (equal centroids)
    cent = scene.tri_v0 + (scene.tri_e1 + scene.tri_e2) / 3.0
    c_d, c_c = cent[p_d.clamp(min=0).long()], cent[p_c.clamp(min=0).long()]
    apart = mism & ((c_d - c_c).abs().amax(dim=1) > 1e-5 * (1.0 + c_d.abs().amax(dim=1)))
    return dict(
        lanes=o.shape[1], prims=scene.n_prims, hits=n_hit,
        misses_equal=bool(((p_c >= 0) == hit).all()),
        max_abs_dt=float(dt_abs.max()),
        t_ok=bool((dt_abs <= T_RTOL * t_d.abs()).all()),
        prim_mismatch_frac=int(mism.sum()) / max(n_hit, 1),
        apart_mismatch_frac=int(apart.sum()) / max(n_hit, 1),
        ties_ok=bool(((t_c - t_d).abs()[mism] <= T_RTOL * t_d.abs()[mism]).all()),
        dense_ms=ms_dense, cluster_ms=ms_cluster, cluster_kernel_ms=ms_kernel,
        at_bound=at_bound, **kernel_vs_plain(scene, o, d, reps, sm_mhz),
    )


def profile_call(render, device) -> dict:
    """One render() under torch.profiler: the device time of all kernels
    and of those of the sweeps (ms), the number of `dense_trace._sweep`
    ranges and the dense kernel's launches (read from the spans that the
    open profiler records).  The device time is read from the device
    events themselves (kernels, copies and fills; not the ranges' own
    device-side annotations), so the kernels launched through ctypes,
    which the profiler ties to no torch call, count too.  A sweep's
    kernels are the dense kernel's launches (by name) and those of the
    torch calls inside a range (the plain sweep's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = sum(metrics.kernel_launches(SWEEP_RANGE, "n").values())
    metrics.clear_spans()

    def in_sweep(evt):
        parent = evt.cpu_parent
        while parent is not None:
            if parent.name == SWEEP_RANGE:
                return True
            parent = parent.cpu_parent
        return False

    device_us = sweep_us = 0.0
    sweeps = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU:
            if evt.name == SWEEP_RANGE:
                sweeps += 1
            elif in_sweep(evt):
                sweep_us += sum(k.duration for k in evt.kernels
                                if k.name != SWEEP_RANGE and DENSE_KERNEL_NAME not in k.name)
        elif not getattr(evt, "is_user_annotation", False) and evt.name != SWEEP_RANGE:
            us = evt.time_range.elapsed_us()
            device_us += us
            if DENSE_KERNEL_NAME in evt.name:
                sweep_us += us
    return dict(profiled_wall_ms=wall_ms, device_ms=device_us / 1e3,
                sweep_device_ms=sweep_us / 1e3, sweeps=sweeps, launches=launches)


def _wavefront_line(name, wname, row):
    print(f"{name} {wname}: {row['lanes']} lanes x {row['prims']} prims; dense "
          f"{row['dense_ms']:.3f} ms (kernel {row['kernel_ms']:.4f} ms, bit-equal to the "
          f"plain sweep={row['bit_equal']}, plain {row['plain_ms']:.3f} ms), cluster tracer "
          f"{row['cluster_ms']:.3f} ms (kernel {row['cluster_kernel_ms']:.4f} ms); "
          f"{row['tested']} of {row['pairs']} (warp, group) pairs tested (culled "
          f"{row['culled_frac']:.4f}), {row['guarded']} guarded ({row['looped']} looped); "
          f"bound of the work done {row['bound_ms']:.4f} ms (share {row['share']:.4f}); the "
          f"brute-force work it no longer does {row['brute_peak_ms']:.4f} ms at the FP32 peak "
          f"(share {row['brute_peak_share']:.4f}), {row['brute_issue_ms']:.4f} ms at its SASS "
          f"count (share {row['brute_issue_share']:.4f}); misses equal="
          f"{row['misses_equal']}, max|dt| {row['max_abs_dt']:.3e} "
          f"ok={row['t_ok']}, prim mismatch {row['prim_mismatch_frac']:.2e} of "
          f"hits ({row['apart_mismatch_frac']:.2e} not between coincident copies), "
          f"{row['at_bound']} lanes at their bound", flush=True)


def timed_frames(scene, cfg, spec, cam, fl, frames: int, sdata):
    """`frames` frames into `fl` between two synchronizes: (film', overflow,
    host ms/frame, peak device memory in bytes over the call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fl, ov = render_frames(scene, cfg, spec, cam, fl, frames, sdata)
    torch.cuda.synchronize()
    return (fl, ov, (time.perf_counter() - t0) / frames * 1e3,
            torch.cuda.max_memory_allocated())


def prism_variants(scene, cfg, spec, cam, frames: int) -> dict:
    """prism_rainbow's frame rate beside the production path's: without
    the shadow cap, and through the cluster tracer (`cluster_tracer`), each
    after a warm-up frame, with one frame's image held against the
    production path's from the same film state."""
    import dataclasses

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import spectral_data

    def one_frame(c, sd):
        fl = film_mod.new_film(SIZE, SIZE, seed=4, device=scene.device)
        return render_frames(scene, c, spec, cam, fl, 1, sd)[0].hdr

    sdata = spectral_data(cfg, cfg.integrator, scene.device)
    base = one_frame(cfg, sdata)
    uncapped = dataclasses.replace(cfg, bdpt_shadow_cap=None)
    out = {}
    for name, c, ctx in (("uncapped", uncapped, contextlib.nullcontext()),
                         ("cluster_tracer", cfg, cluster_tracer())):
        sd = spectral_data(c, c.integrator, scene.device)
        with ctx:
            img = one_frame(c, sd)  # the warm-up too
            fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
            fl, ov, ms, peak = timed_frames(scene, c, spec, cam, fl, frames, sd)
        out[name] = dict(ms_per_frame=ms, overflow=ov, peak_bytes=peak,
                         frame_bit_equal=bool(torch.equal(img, base)),
                         frame_sum=float(img.double().sum()),
                         base_sum=float(base.double().sum()),
                         pixels_close=float(torch.isclose(img, base, rtol=1e-3, atol=1e-6)
                                            .all(dim=-1).float().mean()))
        print(f"prism_rainbow {name}: {ms:.3f} ms/frame over {frames} frames, overflow {ov}, "
              f"peak {peak / 2 ** 20:.1f} MiB; one frame against the production path's: "
              f"bit-equal={out[name]['frame_bit_equal']}, sums {out[name]['frame_sum']:.6f} vs "
              f"{out[name]['base_sum']:.6f}, pixels within rtol 1e-3 "
              f"{out[name]['pixels_close']:.4f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dense_sweep: needs a CUDA card")
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import BDPT, spectral_data
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera

    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    sm_mhz = max_sm_mhz()
    print(f"{card}, max SM clock {sm_mhz:g} MHz", flush=True)
    rows, paths = [], []
    for name in SCENES:
        scene, cfg = EXAMPLES[name](device)
        spec, cam = make_camera(scene, cfg, SIZE, SIZE)
        sdata = spectral_data(cfg, cfg.integrator, device)
        frames = cfg.group or a.frames
        fl = film_mod.new_film(SIZE, SIZE, seed=0, device=device)
        if name == "single_model":
            waves, fl, kills = group_wavefronts(scene, cfg, spec, cam, fl)  # the warm-up too
            for wname, o, d, origin in waves:
                row = dict(scene=name, wavefront=wname,
                           **compare(scene, o, d, origin, a.reps, sm_mhz))
                rows.append(row)
                _wavefront_line(name, wname, row)
            del waves
        else:
            fl, kills = render_frames(scene, cfg, spec, cam, fl, frames, sdata)  # warm-up
        if name == "prism_rainbow":
            waves, n_active = prism_wavefronts(scene, cfg, spec, cam)
            for wname, o, d, tmax in waves:
                row = dict(scene=name, wavefront=wname,
                           **compare(scene, o, d, None, a.reps, sm_mhz, tmax=tmax))
                rows.append(row)
                _wavefront_line(name, wname, row)
            print(f"{name}: {n_active} of the packed shadow batch's lanes are active",
                  flush=True)
            del waves
        fl, ov, ms_frame, peak = timed_frames(scene, cfg, spec, cam, fl, frames, sdata)
        # a BDPT frame is ~80,000 torch calls: one frame under the profiler
        prof_frames = 1 if cfg.integrator in BDPT else frames
        prof = profile_call(
            lambda: render_frames(scene, cfg, spec, cam, fl, prof_frames, sdata), device)
        path = dict(scene=name, integrator=cfg.integrator, prims=scene.n_prims, frames=frames,
                    ms_per_frame=ms_frame, overflow_kills=kills + ov, peak_bytes=peak,
                    device_ms_per_frame=prof["device_ms"] / prof_frames,
                    sweep_device_ms_per_frame=prof["sweep_device_ms"] / prof_frames,
                    sweeps_per_frame=prof["sweeps"] / prof_frames,
                    kernel_launches_per_frame=prof["launches"] / prof_frames,
                    sweep_share=prof["sweep_device_ms"] / max(prof["device_ms"], 1e-9),
                    busy_share=prof["device_ms"] / prof["profiled_wall_ms"],
                    hdr_mean=float(fl.hdr.mean()))
        if name == "prism_rainbow":
            path["variants"] = prism_variants(scene, cfg, spec, cam, frames)
        paths.append(path)
        print(f"{name} ({cfg.integrator}, {scene.n_prims} prims): {ms_frame:.3f} ms/frame "
              f"over {frames} frames, overflow kills {path['overflow_kills']}, peak "
              f"{peak / 2 ** 20:.1f} MiB; device "
              f"{path['device_ms_per_frame']:.3f} ms/frame (busy {path['busy_share']:.3f} of "
              f"the profiled wall), of it {path['sweep_device_ms_per_frame']:.3f} ms in "
              f"{path['sweeps_per_frame']:g} sweeps (share {path['sweep_share']:.3f}), "
              f"{path['kernel_launches_per_frame']:g} dense-kernel launches per frame",
              flush=True)
        del scene
        torch.cuda.empty_cache()
    result = dict(card=card, sm_mhz=sm_mhz, reps=a.reps, wavefronts=rows, paths=paths)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
