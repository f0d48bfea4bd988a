"""The cluster kernel on the wavefronts the three ported paths give it.

    python -m ti_raytrace_tpu_torch.tools.kernel_wavefronts [--reps 20]
        [--out wavefronts.json]

Records, at the tracer's call of `ops.cluster_trace.cluster_trace`, the
kernel's operands during one merged group of the bench main path
(benchmark_100k, 512^2, 16 frames: the camera wavefront and the three
compacted deep widths), one veach_pt frame (bounce 1 and the camera
bounce's NEE shadow rays) and one veach_bdpt frame (the fused depth-1 walk
and the tmax shadow batch of slice 0), then times the kernel on each with
CUDA events (one warm-up launch, then `--reps` launches), profiles one
more such group or frame of each path with torch.profiler for the
kernel's share of the path's device time, and prints one line per
wavefront and per path and a JSON object.  Last, the kernel's time on the
two largest wavefronts of a prism_rainbow frame (`tools/dense_sweep.
prism_wavefronts`: the fused depth-1 walk and the packed tmax shadow
batch, in sorted mode): that path takes the dense tracer, so there is no
share to profile.  chip_smoke.py uses the recorders and the work count
(`bound`).  Needs a CUDA card.
"""

import argparse
import contextlib
import json
import subprocess
import sys

import torch

from ti_raytrace_tpu_torch.ops import cluster_trace as ct

SIZE = 512
BENCH_GROUP = 16

# FP32 operations per test, counted from csrc/cluster_trace.cu (compares,
# min/max and abs count as one, a division as one):
#   slab: 6 sub + 6 mul + 6 min/max per axis pair + 4 min/max combining
#         + max(tn, 0), <=, validity, tn < best                       = 26
#   generic Moller-Trumbore: p 9, det 5, sign 2, T 3, u 6, q 9, v 6, t 6,
#         |det| 1, the inside test 6, 1/|det| 2, t*inv 1, t > 0 1,
#         t < tmin 1, u*inv and v*inv 2                               = 60
#   shared-origin form: det 5, sign 2, u 6, v 6, t 1, |det| 1, inside 6,
#         1/|det| 2, t*inv 1, t > 0 1, t < tmin 1, u*inv and v*inv 2   = 34
SLAB_OPS = 26
MT_OPS = {False: 60, True: 34}
# NVIDIA's data sheet, H100 SXM at 700 W: FP32 outside the tensor cores,
# and HBM3.  Under -fmad=false no multiply fuses with an add, so at most
# half of the FP32 peak is reachable.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound(args, pairs: int, super_entries: int):
    """The least time (ms) the card could take for one launch on operands
    `args`, and what bounds it: the larger of the operations over the
    FP32 peak and of the bytes (rays, tmax, order, bounds, super table,
    triangle table read once; t, prim, u, v, visited written once) over
    the memory rate.  The operations are those this launch's data needs
    (`cluster_trace_plain`'s stats): 128 triangle tests per candidate
    (ray, cluster) pair, and the broad phase of a supercluster skip — each
    live lane's slab test of every super box, plus the 32 cluster-box
    tests of each super box a lane enters before its best hit.  Returns
    (ms, "operations" | "bytes", ops, bytes)."""
    o, n_valid, bounds, order, tri, origin_mt, tmax = (
        args[0], args[2], args[3], args[4], args[5], args[6], args[7])
    n_pad, nc = o.shape[1], bounds.shape[1]
    slabs = n_valid * (nc // ct.GROUP) + ct.GROUP * super_entries
    ops = pairs * ct.CLUSTER_B * MT_OPS[bool(origin_mt)] + slabs * SLAB_OPS
    nbytes = (n_pad * (24 + 16 + (4 if tmax is not None else 0)) + 4 * n_pad // ct.TILE
              + 4 * order.numel() + 4 * bounds.numel() + 4 * 8 * (nc // ct.GROUP)
              + 4 * tri.numel())
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            ops, nbytes)


@contextlib.contextmanager
def recording():
    """Record the operands of every cluster_trace call in the block (the
    tracer's dispatch to the kernel or the plain version), in call order."""
    calls = []
    real = ct.cluster_trace

    def rec(*args):
        calls.append(args)
        return real(*args)

    ct.cluster_trace = rec
    try:
        yield calls
    finally:
        ct.cluster_trace = real


def bench_wavefronts(scene, spec, cam, cfg):
    """The kernel's operands at each width of one merged bench group, in
    launch order (first launch of each width), and every launch's width."""
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    fl = film_mod.new_film(spec.width, spec.height, seed=1, device=scene.device)
    with recording() as calls:
        pt_rgb.render_film_frames_merged(scene, spec, cam, fl, n_frames=BENCH_GROUP,
                                         group=BENCH_GROUP, compaction=cfg.compaction,
                                         pay_divisors=cfg.pay_divisors)
    firsts = {}
    for args in calls:
        firsts.setdefault(args[0].shape[1], args)
    names = ["camera (shared origin, origin-MT)"] + [
        "bounces 1-2 (per-tile order, generic MT)", "bounces 3-7 (per-tile order)",
        "bounces 8-14 (per-tile order)"][:len(firsts) - 1]
    return list(zip(names, firsts.values())), [a[2] for a in calls]


def veach_wavefronts(scene, spec, cam):
    """Bounce 1 and the camera bounce's NEE shadow rays of one veach_pt
    frame (512^2, NEE, exact path: sorted mode), and every launch's live
    width."""
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    fl = film_mod.new_film(spec.width, spec.height, seed=1, device=scene.device)
    with recording() as calls:
        pt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=1, nee=True)
    # per bounce: the hit trace, then its NEE shadow trace
    return ([("NEE shadow rays (sorted)", calls[1]), ("bounce 1 (sorted)", calls[2])],
            [a[2] for a in calls])


def bdpt_wavefronts(scene, spec, cam):
    """The fused depth-1 eye + light walk and the shadow batch (with its
    tmax) of slice 0 of one veach_bdpt frame (512^2, 2 slices), and every
    launch's live width."""
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    with recording() as calls:
        bdpt_rgb.render_frame_sliced(scene, spec, cam, 1, rng.PRNGKey(2), 2)
    shadow = next(a for a in calls if a[7] is not None)
    return ([("fused depth-1 walk (sorted)", calls[0]),
             ("shadow batch (sorted, tmax)", shadow)], [a[2] for a in calls])


def path_profile(record, scene, spec, cam, cfg):
    """(frames, torch.profiler summary) of one more group (bench) or frame
    (veach_pt, veach_bdpt) of the path, after the recording run warmed it."""
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb, pt_rgb
    from ti_raytrace_tpu_torch.tools.profile_bdpt import device_profile

    fl = film_mod.new_film(spec.width, spec.height, seed=2, device=scene.device)
    if record == "bench":
        frames = BENCH_GROUP

        def render():
            pt_rgb.render_film_frames_merged(scene, spec, cam, fl, n_frames=frames,
                                             group=frames, compaction=cfg.compaction,
                                             pay_divisors=cfg.pay_divisors)
    elif record == "veach_pt":
        frames = 1

        def render():
            pt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=1, nee=True)
    else:
        frames = 1

        def render():
            bdpt_rgb.render_frame_sliced(scene, spec, cam, 2, rng.PRNGKey(3), 2)
    return frames, device_profile(render, scene.device)


def time_ms(fn, reps: int):
    """Mean time of fn over reps runs, bracketed by CUDA events, after one
    warm-up run; returns (ms, the last result)."""
    out = fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def _time_waves(record, waves, reps: int):
    """Times the kernel on each (name, operands) and prints its line."""
    rows = []
    for name, args in waves:
        ms, out = time_ms(lambda: ct.KERNEL(*args), reps)
        row = dict(path=record, wavefront=name, lanes=args[2], ms=ms,
                   visited_per_tile=float(out[4].float().mean()))
        rows.append(row)
        print(f"{record} {name}: {args[2]} lanes, {ms:.4f} ms, "
              f"{row['visited_per_tile']:.2f} clusters visited per tile", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_wavefronts: needs a CUDA card")
    from ti_raytrace_tpu_torch.examples.scenes import benchmark_100k, make_camera, veach_bdpt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows, profiles = [], []
    for scene_fn, record in ((benchmark_100k, "bench"), (veach_bdpt, "veach_pt"),
                             (veach_bdpt, "veach_bdpt")):
        scene, cfg = scene_fn("cuda")
        spec, cam = make_camera(scene, cfg, SIZE, SIZE)
        if record == "bench":
            waves, _ = bench_wavefronts(scene, spec, cam, cfg)
        elif record == "veach_pt":
            waves, _ = veach_wavefronts(scene, spec, cam)
        else:
            waves, _ = bdpt_wavefronts(scene, spec, cam)
        rows += _time_waves(record, waves, a.reps)
        del waves
        frames, prof = path_profile(record, scene, spec, cam, cfg)
        prof = dict(path=record, frames=frames, device_ms=prof["device_ms"],
                    kernel_ms=prof["cluster_trace_ms"],
                    kernel_launches=prof["cluster_trace_launches"],
                    profiled_wall_ms=prof["profiled_wall_ms"])
        profiles.append(prof)
        print(f"{record} profile of {frames} frame(s): device {prof['device_ms'] / frames:.3f} "
              f"ms/frame, kernel {prof['kernel_ms'] / frames:.3f} ms/frame in "
              f"{prof['kernel_launches']} launches (share "
              f"{prof['kernel_ms'] / prof['device_ms']:.3f} of device time)", flush=True)
        del scene
        torch.cuda.empty_cache()
    from ti_raytrace_tpu_torch.examples.scenes import prism_rainbow
    from ti_raytrace_tpu_torch.tools.dense_sweep import prism_wavefronts

    scene, cfg = prism_rainbow("cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    waves, _ = prism_wavefronts(scene, cfg, spec, cam)
    rows += _time_waves("prism_rainbow (dense-tracer path)", [
        (f"{name} (sorted)", ct.kernel_inputs(scene, o, d, True, tmax=tmax)[0])
        for name, o, d, tmax in waves], a.reps)
    result = dict(card=card, reps=a.reps, rows=rows, profiles=profiles)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
