"""The dense sweep on the card, and the four paths that ride on it.

    python -m ti_raytrace_tpu_torch.tools.dense_sweep [--reps 5] [--frames 4]
        [--out dense.json]

Part 1, dense against cluster.  Records, at `ops.dense_trace.trace_shaded`,
the camera wavefront (512^2 lanes) and the merged bounce-1 wavefront
(16 x 65,536 lanes) of one single_model group, then traces each with the
dense sweep and, called directly, with the cluster tracer on the same
scene's cluster tables; reports how far the two agree (misses, t, prim)
and, from CUDA events after a warm-up, the dense sweep's time, the
cluster tracer's (its sort and gathers included) and the cluster kernel's
alone, beside the sweep's arithmetic bound, lanes x prims x 60 operations
at the FP32 peak.  sphere.obj holds each of its 760 triangles three
times, so most hits are exact t-ties between coincident copies, where the
dense sweep reports the lowest index and the cluster tracer the first in
its sweep order: differing prims are counted in all and apart from such
copies.

Part 2, the paths.  For cornell_box, single_model, sky_dome and
spectral_box at 512^2, rendered as the CLI renders them (`render_frames`):
host ms/frame over `--frames` frames (single_model: whole groups of 16)
after a warm-up, the overflow kills, and from torch.profiler over one
more call the device ms/frame and the share of it spent inside
`dense_trace._sweep` (the kernels launched inside that record_function
range).  chip_smoke.py uses the recorder, the comparison and
`render_frames`.  Needs a CUDA card.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

from ti_raytrace_tpu_torch.ops import dense_trace as dt
from ti_raytrace_tpu_torch.tools.kernel_wavefronts import PEAK_FP32, time_ms

SIZE = 512
SCENES = ("cornell_box", "single_model", "sky_dome", "spectral_box")
SWEEP_RANGE = "dense_trace._sweep"  # the record_function range of ops/dense_trace.py
MT_OPS = 60  # FP32 operations of one ray-triangle test (tools/kernel_wavefronts.py)
T_RTOL = 1e-5


def sweep_bound_ms(lanes: int, prims: int) -> float:
    """The least time the card could take for the sweep's arithmetic:
    every lane against every prim, MT_OPS operations each, at the FP32
    peak.  (The bytes, rays in and hits out once, are far below it.)"""
    return lanes * prims * MT_OPS / PEAK_FP32 * 1e3


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


def compare(scene, o, d, shared_origin, reps: int) -> dict:
    """The dense sweep and the cluster tracer on one wavefront of a scene
    that has both tables: agreement and times.  The camera wavefront goes
    to the cluster tracer as the path tracer would send it (shared origin,
    unsorted), any other through its sorted mode."""
    from ti_raytrace_tpu_torch.ops import cluster_trace as ct

    if shared_origin is not None:
        kw = dict(sort_rays=False, shared_origin=shared_origin)
    else:
        kw = dict(sort_rays=True, sort_small=True)
    ms_dense, (t_d, p_d, _, _) = time_ms(lambda: dt.trace_shaded(scene, o, d), reps)
    ms_cluster, (t_c, p_c, _, _) = time_ms(
        lambda: ct.trace_clustered(scene, o, d, want_attr=True, **kw), reps)
    args, _ = ct.kernel_inputs(scene, o, d, kw["sort_rays"], shared_origin)
    ms_kernel, _ = time_ms(lambda: ct.KERNEL(*args), reps)
    hit = p_d >= 0
    n_hit = int(hit.sum())
    dt_abs = torch.where(hit & (p_c >= 0), (t_c - t_d).abs(), 0.0)
    mism = hit & (p_c >= 0) & (p_c != p_d)
    # differing prims that are not copies of one triangle (equal centroids)
    cent = scene.tri_v0 + (scene.tri_e1 + scene.tri_e2) / 3.0
    c_d, c_c = cent[p_d.clamp(min=0).long()], cent[p_c.clamp(min=0).long()]
    apart = mism & ((c_d - c_c).abs().amax(dim=1) > 1e-5 * (1.0 + c_d.abs().amax(dim=1)))
    lanes = o.shape[1]
    bound = sweep_bound_ms(lanes, scene.n_prims)
    return dict(
        lanes=lanes, prims=scene.n_prims, hits=n_hit,
        misses_equal=bool(((p_c >= 0) == hit).all()),
        max_abs_dt=float(dt_abs.max()),
        t_ok=bool((dt_abs <= T_RTOL * t_d.abs()).all()),
        prim_mismatch_frac=int(mism.sum()) / max(n_hit, 1),
        apart_mismatch_frac=int(apart.sum()) / max(n_hit, 1),
        ties_ok=bool(((t_c - t_d).abs()[mism] <= T_RTOL * t_d.abs()[mism]).all()),
        dense_ms=ms_dense, cluster_ms=ms_cluster, cluster_kernel_ms=ms_kernel,
        bound_ms=bound, share=bound / ms_dense,
    )


def profile_call(render, device) -> dict:
    """One render() under torch.profiler: the device time of all kernels
    and of those launched inside `dense_trace._sweep` ranges (ms), and the
    number of ranges.  A kernel is charged to the torch call that launched
    it (the profiler's `kernels` of that call's event) and belongs to a
    sweep when a range is among that call's parents; the range's own
    device-side mirror (an annotation spanning its kernels) is left out of
    both sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3

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
        if evt.device_type != DeviceType.CPU:
            continue
        if evt.name == SWEEP_RANGE:
            sweeps += 1
            continue
        own = sum(k.duration for k in evt.kernels)
        device_us += own
        if own and in_sweep(evt):
            sweep_us += own
    return dict(profiled_wall_ms=wall_ms, device_ms=device_us / 1e3,
                sweep_device_ms=sweep_us / 1e3, sweeps=sweeps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dense_sweep: needs a CUDA card")
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import spectral_data
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera

    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
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
                row = dict(scene=name, wavefront=wname, **compare(scene, o, d, origin, a.reps))
                rows.append(row)
                print(f"{name} {wname}: {row['lanes']} lanes x {row['prims']} prims; dense "
                      f"{row['dense_ms']:.3f} ms, cluster tracer {row['cluster_ms']:.3f} ms "
                      f"(kernel {row['cluster_kernel_ms']:.4f} ms), bound "
                      f"{row['bound_ms']:.4f} ms (share {row['share']:.4f}); misses equal="
                      f"{row['misses_equal']}, max|dt| {row['max_abs_dt']:.3e} "
                      f"ok={row['t_ok']}, prim mismatch {row['prim_mismatch_frac']:.2e} of "
                      f"hits ({row['apart_mismatch_frac']:.2e} not between coincident copies)",
                      flush=True)
            del waves
        else:
            fl, kills = render_frames(scene, cfg, spec, cam, fl, frames, sdata)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl, ov = render_frames(scene, cfg, spec, cam, fl, frames, sdata)
        torch.cuda.synchronize()
        ms_frame = (time.perf_counter() - t0) / frames * 1e3
        prof = profile_call(lambda: render_frames(scene, cfg, spec, cam, fl, frames, sdata),
                            device)
        path = dict(scene=name, integrator=cfg.integrator, prims=scene.n_prims, frames=frames,
                    ms_per_frame=ms_frame, overflow_kills=kills + ov,
                    device_ms_per_frame=prof["device_ms"] / frames,
                    sweep_device_ms_per_frame=prof["sweep_device_ms"] / frames,
                    sweeps_per_frame=prof["sweeps"] / frames,
                    sweep_share=prof["sweep_device_ms"] / max(prof["device_ms"], 1e-9),
                    busy_share=prof["device_ms"] / prof["profiled_wall_ms"],
                    hdr_mean=float(fl.hdr.mean()))
        paths.append(path)
        print(f"{name} ({cfg.integrator}, {scene.n_prims} prims): {ms_frame:.3f} ms/frame "
              f"over {frames} frames, overflow kills {path['overflow_kills']}; device "
              f"{path['device_ms_per_frame']:.3f} ms/frame (busy {path['busy_share']:.3f} of "
              f"the profiled wall), of it {path['sweep_device_ms_per_frame']:.3f} ms in "
              f"{path['sweeps_per_frame']:g} sweeps (share {path['sweep_share']:.3f})",
              flush=True)
        del scene
        torch.cuda.empty_cache()
    result = dict(card=card, reps=a.reps, wavefronts=rows, paths=paths)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
