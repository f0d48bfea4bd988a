#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three paths — the 100k-triangle benchmark scene
rendered by `integrators.pt_rgb.render_film_frames_merged` at 512x512,
the Veach MIS scene rendered by `pt_rgb.render_film_frames` with NEE (the
reference's veach_pt golden path), and the same scene under BDPT
(`bdpt_rgb.render_frame_sliced` in 2 slices, the veach_bdpt golden path)
— and holds the CUDA kernel against its plain PyTorch version in every
mode the paths use.
Phases, each printing its own lines; any failure exits non-zero:

  1. device: the card's name and power limit (nvidia-smi), torch/CUDA;
  2. kernel build: csrc/cluster_trace.cu compiled with nvcc, timed;
  3. kernel vs cluster_trace_plain on two real wavefronts of the scene:
     the 512^2 camera wavefront (shared origin, origin-MT table) and a
     merged deep-bounce wavefront from the port's own path (presorted
     carry, per-tile order, generic MT) — t within rtol 1e-5, prim ids
     equal except on t-ties (at most 0.1% of hits);
  4. main path: a warm-up dispatch, then timed dispatches of KF=16
     frames in merged groups of 16 with the bench schedule; zero overflow
     kills, a finite non-negative HDR and kernel launches > 0;
  5. the same 32^2 render on CUDA and on the CPU (plain version) from one
     seed, compared pixel by pixel;
  6. the Veach scene on CUDA: kernel vs plain on two sorted-mode
     wavefronts of a 512^2 frame — bounce 1 of the exact path and the
     camera bounce's NEE shadow rays — with phase 3's bar;
  7. veach_pt: 512^2, max depth 15, NEE, exact path, VEACH_FRAMES frames
     in one render_film_frames call; zero overflow kills, a finite
     non-negative HDR with mean > 0, kernel launches > 0, ms/frame;
  8. the same 32^2 Veach render on CUDA and on the CPU, as in phase 5;
  9. veach_bdpt: kernel vs plain on two sorted-mode wavefronts of one
     512^2 slice, recorded at bdpt_rgb's calls of the tracer — the fused
     depth-1 eye+light walk wavefront (262,144 lanes) and the shadow
     batch of all 20 strategies (2,621,440 lanes, with per-lane tmax) —
     with phase 3's bar and equal visited counts; the plain version runs
     on blocks of PLAIN_TILES tiles to bound its memory;
 10. veach_bdpt at 512^2, MAX_DEPTH 5, 2 slices, BDPT_FRAMES frames
     through render_frame_sliced + film.accumulate: zero walk overflow, a
     finite non-negative HDR with mean > 0, kernel launches > 0,
     ms/frame; then one frame rendered twice from one key, bit-equal
     (the splat is a deterministic scatter-add);
 11. the same 32^2 BDPT render on CUDA and on the CPU, as in phase 5.

The next-to-last line is a JSON object describing the kernel (launches
summed over the three paths' counted runs, max_abs_err the worst over
every compared wavefront); the last line is {"ok": true, "device":
{...}}.  Without CUDA, or without the package beside it, the script
exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

SIZE = 512
KF = 16          # frames per dispatch
GROUP = 16       # frames per merged group
TIMED_DISPATCHES = 2
DEEP_FRAMES = 2  # frames whose compacted carries form the deep wavefront
SMALL = 32       # phase 5 and 8 film size
VEACH_FRAMES = 8
BDPT_FRAMES = 4
PLAIN_TILES = 1024  # tiles per block of the plain version in phase 9
T_RTOL = 1e-5
PRIM_TIE_FRAC = 1e-3


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def _time_ms(fn, reps, sync):
    """Mean wall time of fn over reps runs, each bracketed by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    sync()
    return start.elapsed_time(stop) / reps, out


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[1 device] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL

    t0 = time.perf_counter()
    KERNEL.library()
    info = KERNEL.build_info
    log(f"[2 build] {time.perf_counter() - t0:.2f} s (nvcc {info.seconds:.2f} s, "
        f"built={info.built}) -> {info.path}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build] ptxas: {line.strip()}")


def _deep_wavefront(scene, spec, cam, key):
    """A merged deep-bounce wavefront of the port's own path: DEEP_FRAMES
    frames' prologues (bounce 0, flush, compact to the phase-1 width),
    concatenated and presorted as _while_bounces does before bounce 1."""
    import torch

    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.examples.scenes import BENCH_SCHEDULE_MERGED
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    N = spec.width * spec.height
    w1 = pt_rgb._phase_width(N, BENCH_SCHEDULE_MERGED[0][1])
    carries = []
    for g in range(DEEP_FRAMES):
        k_cam, k_path = rng.split(key)
        o, d, _ = pt_rgb._camera_rays(spec, cam, g, k_cam)
        c = pt_rgb._bounce(scene, pt_rgb._new_carry(o, d), rng.fold_in(k_path, 0),
                           shared_origin=o[:, 0])
        c, _ = pt_rgb._flush(c, pt_rgb._new_accum(N, o.device), identity=True)
        c, _ = pt_rgb._compact(c, w1)
        carries.append(c)
        key = rng.split(key)[0]
    carry = {k: torch.cat([c[k] for c in carries], dim=-1) for k in carries[0]}
    carry = pt_rgb._sort_carry(scene, carry)
    return carry["origin"].contiguous(), carry["direction"].contiguous()


def _plain_blocks(inputs, tiles):
    """cluster_trace_plain over blocks of `tiles` ray tiles (the order
    rows of a per-tile order go with their tiles), concatenated: the
    same result as one call, with bounded temporaries."""
    import torch

    from ti_raytrace_tpu_torch.ops.cluster_trace import TILE, cluster_trace_plain

    o, d, n_valid, bounds, order, tri, origin_mt, tmax = inputs
    n_pad = o.shape[1]
    step = tiles * TILE
    outs = []
    for a in range(0, n_pad, step):
        b = min(n_pad, a + step)
        rows = order if order.shape[0] == 1 else order[a // TILE:b // TILE]
        outs.append(cluster_trace_plain(
            o[:, a:b], d[:, a:b], min(max(n_valid - a, 0), b - a), bounds, rows, tri,
            origin_mt, None if tmax is None else tmax[a:b]))
    return tuple(torch.cat(x) for x in zip(*outs))


def _compare(name, inputs, sync, tag="[3 kernel]", plain_tiles=None):
    """Kernel vs plain version on one wavefront; returns (max |dt|,
    kernel ms, plain ms).  plain_tiles: run the plain version in blocks
    of that many tiles."""
    import torch

    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL, cluster_trace_plain

    def plain():
        if plain_tiles:
            return _plain_blocks(inputs, plain_tiles)
        return cluster_trace_plain(*inputs)

    ms_k, (t_k, p_k, u_k, v_k, vis_k) = _time_ms(lambda: KERNEL(*inputs), 5, sync)
    ms_p, (t_p, p_p, u_p, v_p, vis_p) = _time_ms(plain, 1, sync)
    n = inputs[2]
    t_k, t_p, p_k, p_p = t_k[:n], t_p[:n], p_k[:n], p_p[:n]
    hit = p_p >= 0
    n_hit = int(hit.sum())
    dt = torch.where(hit, (t_k - t_p).abs(), 0.0)
    max_dt = float(dt.max())
    t_ok = bool((dt <= T_RTOL * t_p.abs()).all())
    mism = hit & (p_k != p_p)
    frac = int(mism.sum()) / max(n_hit, 1)
    ties_ok = bool(((t_k - t_p).abs()[mism] <= 1e-5).all())
    miss_ok = bool((p_k[~hit] == p_p[~hit]).all())
    duv = float(torch.maximum((u_k - u_p)[:n].abs().max(), (v_k - v_p)[:n].abs().max()))
    vis_ok = bool((vis_k == vis_p).all())
    log(f"{tag} {name}: {n} lanes, {n_hit} hits; max|dt| {max_dt:.3e} "
        f"(rtol {T_RTOL} ok={t_ok}); prim mismatch {frac:.2e} of hits "
        f"(ties ok={ties_ok}); misses equal={miss_ok}; max|duv| {duv:.3e}; "
        f"visited equal={vis_ok} "
        f"(mean {float(vis_k.float().mean()):.1f} clusters/tile); "
        f"kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")
    if not (n_hit > 0 and t_ok and frac <= PRIM_TIE_FRAC and ties_ok and miss_ok and vis_ok):
        fail(f"kernel disagrees with cluster_trace_plain on the {name} wavefront")
    return max_dt, ms_k, ms_p


def phase_kernel(scene, spec, cam, sync):
    import torch

    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import pt_rgb
    from ti_raytrace_tpu_torch.ops.cluster_trace import kernel_inputs

    key = rng.PRNGKey(0)
    o, d, _ = pt_rgb._camera_rays(spec, cam, 1, rng.split(key)[0])
    cam_in = kernel_inputs(scene, o, d, False, shared_origin=o[:, 0].contiguous())[0]
    err_c, ms_c, plain_c = _compare("camera 512^2 (shared origin, origin-MT)", cam_in, sync)
    do, dd = _deep_wavefront(scene, spec, cam, key)
    deep_in = kernel_inputs(scene, do, dd, False, tile_order=True)[0]
    err_d, ms_d, plain_d = _compare("merged deep bounce (per-tile order, generic MT)",
                                    deep_in, sync)
    del cam_in, deep_in
    torch.cuda.empty_cache()
    return max(err_c, err_d), ms_c, plain_c


def phase_main_path(scene, spec, cam, cfg, sync):
    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.integrators import pt_rgb
    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL

    def dispatch(fl):
        return pt_rgb.render_film_frames_merged(
            scene, spec, cam, fl, n_frames=KF, group=GROUP, compaction=cfg.compaction,
            pay_divisors=cfg.pay_divisors,
        )

    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    t0 = time.perf_counter()
    fl, kills = dispatch(fl)
    sync()
    log(f"[4 main] warm-up dispatch: {KF} frames in {time.perf_counter() - t0:.2f} s, "
        f"overflow kills {kills}")

    KERNEL.launches = 0  # count only the timed main-path run below
    times = []
    for _ in range(TIMED_DISPATCHES):
        t0 = time.perf_counter()
        fl, ov = dispatch(fl)
        sync()
        times.append(time.perf_counter() - t0)
        kills += ov
    launches = KERNEL.launches
    hdr = fl.hdr
    ok_img = (tuple(hdr.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(hdr).all())
              and bool((hdr >= 0).all()) and float(hdr.mean()) > 0.0)
    ms = [t / KF * 1e3 for t in times]
    log(f"[4 main] {SIZE}^2 merged G={GROUP}, {TIMED_DISPATCHES} timed dispatches of "
        f"{KF} frames: ms/frame " + ", ".join(f"{m:.3f}" for m in ms)
        + f" (mean {sum(ms) / len(ms):.3f}); overflow kills {kills}; kernel launches "
        f"{launches}; frames {fl.frame}; hdr mean {float(hdr.mean()):.5f}")
    if kills != 0:
        fail(f"{kills} compaction overflow kills on the main path")
    if not ok_img:
        fail("the main path's HDR is not a finite, non-negative (W, H, 3) image")
    if launches == 0:
        fail("the main path never launched the cluster_trace kernel")
    return launches


def _small_parity(tag, render):
    """render(device) -> ((W, H, 3) HDR, overflow kills), on CUDA and on
    the CPU (plain version); the two HDRs are compared pixel by pixel."""
    import numpy as np

    hdrs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        hdr, kills = render(dev)
        hdrs[dev] = hdr.cpu().numpy()
        log(f"{tag} {SMALL}^2 on {dev}: {time.perf_counter() - t0:.2f} s, "
            f"overflow kills {kills}")
    a, b = hdrs["cuda"], hdrs["cpu"]
    close = np.isclose(a, b, rtol=1e-3, atol=1e-6).all(axis=-1).mean()
    rel_mean = abs(a.mean() - b.mean()) / max(b.mean(), 1e-12)
    log(f"{tag} pixels within rtol 1e-3: {close:.4f}; image means "
        f"{a.mean():.6f} vs {b.mean():.6f} (rel {rel_mean:.2e})")
    if close < 0.98 or rel_mean > 0.01 or not b.mean() > 0.0:
        fail("the CUDA render disagrees with the CPU plain render")


def phase_small_parity(cfg):
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.scenes import benchmark_100k, make_camera
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    def render(dev):
        scene, _ = benchmark_100k(dev)
        spec, cam = make_camera(scene, cfg, SMALL, SMALL)
        fl, kills = pt_rgb.render_film_frames_merged(
            scene, spec, cam, film_mod.new_film(SMALL, SMALL, seed=3, device=dev),
            n_frames=2, group=2, compaction=cfg.compaction, pay_divisors=cfg.pay_divisors)
        return fl.hdr, kills

    _small_parity("[5 parity]", render)


def _veach_wavefronts(scene, spec, cam):
    """Two sorted-mode wavefronts of a 512^2 Veach frame, as the exact
    path traces them: bounce 1 (the carry after the camera bounce) and
    the camera bounce's NEE shadow rays, recorded at pt_rgb's call of
    accel.trace."""
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    k_cam, k_path = rng.split(rng.PRNGKey(1))
    o, d, _ = pt_rgb._camera_rays(spec, cam, 0, k_cam)
    shadow = []
    accel_trace = pt_rgb.trace

    def recording_trace(scene, o, d, **kw):
        shadow.append((o, d))
        return accel_trace(scene, o, d, **kw)

    pt_rgb.trace = recording_trace
    try:
        carry = pt_rgb._bounce(scene, pt_rgb._new_carry(o, d), rng.fold_in(k_path, 0),
                               nee=True, shared_origin=o[:, 0])
    finally:
        pt_rgb.trace = accel_trace
    if len(shadow) != 1:
        fail(f"the camera bounce traced {len(shadow)} shadow wavefronts, not 1")
    return (carry["origin"], carry["direction"]), shadow[0]


def phase_veach_kernel(scene, spec, cam, sync):
    import torch

    from ti_raytrace_tpu_torch.ops.cluster_trace import kernel_inputs

    (bo, bd), (so, sd) = _veach_wavefronts(scene, spec, cam)
    errs, ms = [], []
    for name, o, d in (("bounce 1 (sorted, per-tile order)", bo, bd),
                       ("NEE shadow rays (sorted, per-tile order)", so, sd)):
        err, ms_k, ms_p = _compare(name, kernel_inputs(scene, o, d, True)[0], sync,
                                   tag="[6 veach kernel]")
        errs.append(err)
        ms.append((ms_k, ms_p))
    torch.cuda.empty_cache()
    return max(errs), ms


def phase_veach_path(scene, spec, cam, cfg, sync):
    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.integrators import pt_rgb
    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL

    nee = pt_rgb.has_nee_materials(scene)
    if not nee:
        fail("the Veach scene has no material that takes NEE")
    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    KERNEL.launches = 0  # count only this path's run
    t0 = time.perf_counter()
    fl, kills = pt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=VEACH_FRAMES,
                                          compaction=cfg.compaction, nee=nee)
    sync()
    seconds = time.perf_counter() - t0
    launches = KERNEL.launches
    hdr = fl.hdr
    ok_img = (tuple(hdr.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(hdr).all())
              and bool((hdr >= 0).all()) and float(hdr.mean()) > 0.0)
    log(f"[7 veach] veach_pt {SIZE}^2, max depth {pt_rgb.MAX_DEPTH}, NEE, exact path: "
        f"{VEACH_FRAMES} frames in {seconds:.2f} s = {seconds / VEACH_FRAMES * 1e3:.3f} "
        f"ms/frame; overflow kills {kills}; kernel launches {launches}; "
        f"hdr mean {float(hdr.mean()):.5f}")
    if kills != 0:
        fail(f"{kills} overflow kills on the veach_pt path")
    if not ok_img:
        fail("the veach_pt HDR is not a finite, non-negative (W, H, 3) image")
    if launches == 0:
        fail("the veach_pt path never launched the cluster_trace kernel")
    return launches


def phase_veach_parity(cfg):
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.scenes import make_camera, veach_bdpt
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    def render(dev):
        scene, _ = veach_bdpt(dev)
        spec, cam = make_camera(scene, cfg, SMALL, SMALL)
        fl, kills = pt_rgb.render_film_frames(
            scene, spec, cam, film_mod.new_film(SMALL, SMALL, seed=3, device=dev),
            n_frames=2, nee=True)
        return fl.hdr, kills

    _small_parity("[8 veach parity]", render)


def _bdpt_wavefronts(scene, spec, cam):
    """Two sorted-mode wavefronts of slice 0 of a 512^2 veach_bdpt frame,
    recorded at bdpt_rgb's calls of the tracer: the fused depth-1 eye +
    light walk trace and the shadow batch (with its tmax)."""
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    walks, shadows = [], []
    accel_trace, accel_shaded = bdpt_rgb.trace, bdpt_rgb.trace_shaded

    def recording_shaded(scene, o, d, **kw):
        walks.append((o, d))
        return accel_shaded(scene, o, d, **kw)

    def recording_trace(scene, o, d, **kw):
        shadows.append((o, d, kw))
        return accel_trace(scene, o, d, **kw)

    bdpt_rgb.trace, bdpt_rgb.trace_shaded = recording_trace, recording_shaded
    try:
        keys = rng.split(rng.PRNGKey(2), 4)
        o, d = bdpt_rgb._camera_rays(spec, cam, 1, keys[0])
        ns = o.shape[1] // 2
        bdpt_rgb._render_slice(scene, spec, cam, o[:, :ns], d[:, :ns], keys, 0,
                               bdpt_rgb.MAX_DEPTH, None, None)
    finally:
        bdpt_rgb.trace, bdpt_rgb.trace_shaded = accel_trace, accel_shaded
    if len(walks) != bdpt_rgb.MAX_DEPTH + 1 or len(shadows) != 1:
        fail(f"one BDPT slice traced {len(walks)} walk and {len(shadows)} shadow "
             f"wavefronts, not {bdpt_rgb.MAX_DEPTH + 1} and 1")
    so, sd, kw = shadows[0]
    if kw.get("tmax") is None or kw.get("active") is not None:
        fail("the BDPT shadow batch is not a tmax-bounded trace without a cap")
    return walks[0], (so, sd, kw["tmax"])


def phase_bdpt_kernel(scene, spec, cam, sync):
    import torch

    from ti_raytrace_tpu_torch.ops.cluster_trace import kernel_inputs

    (wo, wd), (so, sd, tmax) = _bdpt_wavefronts(scene, spec, cam)
    errs, ms = [], []
    for name, o, d, tm in (("fused depth-1 walk (sorted)", wo, wd, None),
                           ("shadow batch (sorted, tmax)", so, sd, tmax)):
        inputs = kernel_inputs(scene, o, d, True, tmax=tm)[0]
        n_blocks = -(-inputs[0].shape[1] // (PLAIN_TILES * 256))
        err, ms_k, ms_p = _compare(f"{name}, plain in {n_blocks} block(s)", inputs, sync,
                                   tag="[9 bdpt kernel]", plain_tiles=PLAIN_TILES)
        errs.append(err)
        ms.append((ms_k, ms_p))
        del inputs
    torch.cuda.empty_cache()
    return max(errs), ms


def phase_bdpt_path(scene, spec, cam, cfg, sync):
    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb
    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL

    def frames(fl, n):
        return bdpt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=n, n_slices=2,
                                           walk_compaction=cfg.bdpt_walk_compaction,
                                           shadow_cap=cfg.bdpt_shadow_cap)

    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    t0 = time.perf_counter()
    fl, overflow = frames(fl, 1)  # warm-up
    sync()
    log(f"[10 bdpt] warm-up frame {time.perf_counter() - t0:.2f} s, overflow {overflow}")
    KERNEL.launches = 0  # count only the timed run below
    t0 = time.perf_counter()
    fl, ov = frames(fl, BDPT_FRAMES)
    sync()
    seconds = time.perf_counter() - t0
    launches = KERNEL.launches
    overflow += ov
    hdr = fl.hdr
    ok_img = (tuple(hdr.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(hdr).all())
              and bool((hdr >= 0).all()) and float(hdr.mean()) > 0.0)
    log(f"[10 bdpt] veach_bdpt {SIZE}^2, MAX_DEPTH {bdpt_rgb.MAX_DEPTH}, 2 slices: "
        f"{BDPT_FRAMES} frames in {seconds:.2f} s = {seconds / BDPT_FRAMES * 1e3:.3f} "
        f"ms/frame; walk overflow {overflow}; kernel launches {launches}; "
        f"hdr mean {float(hdr.mean()):.5f}")
    key = rng.PRNGKey(7)
    a = bdpt_rgb.render_frame_sliced(scene, spec, cam, 3, key, 2)
    b = bdpt_rgb.render_frame_sliced(scene, spec, cam, 3, key, 2)
    same = bool(torch.equal(a, b))
    log(f"[10 bdpt] one frame rendered twice from one key: bit-equal={same} "
        f"(mean {float(a.mean()):.5f})")
    if overflow != 0:
        fail(f"{overflow} walk overflow on the veach_bdpt path")
    if not ok_img:
        fail("the veach_bdpt HDR is not a finite, non-negative (W, H, 3) image")
    if launches == 0:
        fail("the veach_bdpt path never launched the cluster_trace kernel")
    if not same:
        fail("two renders of one BDPT frame from one key differ")
    return launches


def phase_bdpt_parity(cfg):
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.scenes import make_camera, veach_bdpt
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    def render(dev):
        scene, _ = veach_bdpt(dev)
        spec, cam = make_camera(scene, cfg, SMALL, SMALL)
        fl, overflow = bdpt_rgb.render_film_frames(
            scene, spec, cam, film_mod.new_film(SMALL, SMALL, seed=3, device=dev),
            n_frames=2, n_slices=2)
        return fl.hdr, overflow

    _small_parity("[11 bdpt parity]", render)


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ti_raytrace_tpu_torch")):
        fail("the ti_raytrace_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    from ti_raytrace_tpu_torch.examples.scenes import benchmark_100k, make_camera, veach_bdpt

    phase_device()
    phase_build()
    t0 = time.perf_counter()
    scene, cfg = benchmark_100k("cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    log(f"[3 kernel] scene: {scene.n_prims} prims, {scene.cluster_bounds.shape[1]} "
        f"clusters, built in {time.perf_counter() - t0:.2f} s")
    max_err, ms, plain_ms = phase_kernel(scene, spec, cam, sync)
    launches = phase_main_path(scene, spec, cam, cfg, sync)
    phase_small_parity(cfg)
    del scene
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    vscene, vcfg = veach_bdpt("cuda")
    vspec, vcam = make_camera(vscene, vcfg, SIZE, SIZE)
    log(f"[6 veach kernel] scene: {vscene.n_prims} prims, {vscene.n_lights} lights, "
        f"{vscene.cluster_bounds.shape[1]} clusters, built in "
        f"{time.perf_counter() - t0:.2f} s")
    err_v, veach_ms = phase_veach_kernel(vscene, vspec, vcam, sync)
    max_err = max(max_err, err_v)
    launches += phase_veach_path(vscene, vspec, vcam, vcfg, sync)
    phase_veach_parity(vcfg)
    log("[6 veach kernel] kernel vs plain ms: " + "; ".join(
        f"{k:.3f} vs {p:.3f}" for k, p in veach_ms))

    err_b, bdpt_ms = phase_bdpt_kernel(vscene, vspec, vcam, sync)
    max_err = max(max_err, err_b)
    launches += phase_bdpt_path(vscene, vspec, vcam, vcfg, sync)
    phase_bdpt_parity(vcfg)
    log("[9 bdpt kernel] kernel vs plain ms: " + "; ".join(
        f"{k:.3f} vs {p:.3f}" for k, p in bdpt_ms))
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "cluster_trace",
        "route": "cuda",
        "source": "ti_raytrace_tpu_torch/csrc/cluster_trace.cu",
        "replaces": "ti_raytrace_tpu/ops/cluster_trace.py:189",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
