#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths — the 100k-triangle benchmark scene rendered by
`integrators.pt_rgb.render_film_frames_merged` at 512x512, the Veach MIS
scene rendered by `pt_rgb.render_film_frames` with NEE (the reference's
veach_pt golden path), the same scene under BDPT
(`bdpt_rgb.render_frame_sliced` in 2 slices, the veach_bdpt golden path),
the four path-traced scenes of the dense tracer (single_model,
cornell_box, sky_dome, spectral_box) and the prism dispersion scene under
spectral BDPT (`bdpt_spec.make_render_frame`, unsliced, the prism_rainbow
golden path), and the five sharded paths of `parallel/shard.py` on 2
ranks sharing the card — and holds the six CUDA kernels against their
plain PyTorch versions: the cluster kernel (csrc/cluster_trace.cu) in
every mode the paths use, the dense sweep's kernel (csrc/dense_trace.cu)
on the dense paths' wavefronts, bit for bit, and the threefry kernel
(csrc/rng.cu, every draw of every path) bit for bit on every shape the
paths draw, the Disney and PT shading kernels (csrc/disney.cu,
csrc/pt_shade.cu) bit for bit on random lanes, the coherence key kernel
(csrc/coherence_key.cu) bit for bit at every width the cluster paths key;
and the dense tracer
against the cluster tracer.  Every path phase also counts the threefry
kernel's launches in its counted run (they must be > 0) and prints its
draws per frame by elements drawn.  A counted run records the program's
spans (metrics.recording), the only record of launches (each launch is
counted on its span where it launches), and counts each kernel's
launches from them (metrics.kernel_launches); its timed ms include the
spans' own host cost and, on a dense path, the dense kernel's counting
variant (a recording `dense_trace._sweep` span passes it `counts`).
Phases, each printing its own lines; any failure exits non-zero:

  1. device: the card's name and power limit (nvidia-smi), its maximum SM
     clock (the threefry kernel's bound), torch/CUDA;
  2. kernel build: csrc/cluster_trace.cu, csrc/dense_trace.cu,
     csrc/rng.cu, csrc/disney.cu, csrc/pt_shade.cu and
     csrc/coherence_key.cu, one nvcc for each,
     started together with the dense kernel's SASS probes (tools/sass.py),
     timed, with ptxas's registers
     and each dense part's instructions by pipe;
  3. kernel vs cluster_trace_plain on the bench's own wavefronts, recorded
     at the tracer during one merged group of the main path (16 frames):
     the 512^2 camera wavefront (shared origin, origin-MT table) and the
     three compacted deep widths (838,848, 174,752 and 32,768 lanes,
     presorted, per-tile order, generic MT) — t within rtol 1e-5, prim ids
     equal except on t-ties (at most 0.1% of hits), misses and visited
     counts equal; per wavefront the kernel's and the plain version's
     times, the clusters visited per tile, the candidate (ray, cluster)
     pairs, the super-box entries and the bound
     (tools/kernel_wavefronts.bound) with its share;
  4. main path: a warm-up dispatch, then timed dispatches of KF=16
     frames in merged groups of 16 with the bench schedule; zero overflow
     kills, a finite non-negative HDR and kernel launches > 0, and the
     kernel's launches per frame by live width (from the spans);
  5. the same 32^2 render on CUDA and on the CPU (plain version) from one
     seed, compared pixel by pixel;
  6. the Veach scene on CUDA: kernel vs plain on two sorted-mode
     wavefronts of a 512^2 veach_pt frame — the camera bounce's NEE
     shadow rays and bounce 1 of the exact path — with phase 3's bar;
  7. veach_pt: 512^2, max depth 15, NEE, exact path, VEACH_FRAMES frames
     in one render_film_frames call; zero overflow kills, a finite
     non-negative HDR with mean > 0, kernel launches > 0, ms/frame;
  8. the same 32^2 Veach render on CUDA and on the CPU, as in phase 5;
  9. veach_bdpt: kernel vs plain on two sorted-mode wavefronts of slice
     0 of a 512^2 frame — the fused depth-1 eye+light walk wavefront
     (262,144 lanes) and the shadow batch of all 20 strategies (2,621,440
     lanes, with per-lane tmax) — with phase 3's bar;
 10. veach_bdpt at 512^2, MAX_DEPTH 5, 2 slices, BDPT_FRAMES frames
     through render_frame_sliced + film.accumulate: zero walk overflow, a
     finite non-negative HDR with mean > 0, kernel launches > 0,
     ms/frame; then one frame rendered twice from one key, bit-equal
     (the splat is a deterministic scatter-add);
 11. the same 32^2 BDPT render on CUDA and on the CPU, as in phase 5;
 12. single_model (2,281 prims: the dense tracer) at 512^2 in merged groups
     of 16 with its schedule: a warm-up group, recorded at the dense
     tracer, then DENSE_GROUPS timed groups; zero overflow kills, a finite
     non-negative HDR with mean > 0, ms/frame, no launch of the cluster
     kernel (the dispatch took the dense tracer) and launches of the dense
     kernel (its launches per frame by width, from the timed run's
     spans);
 13. dense vs cluster on the recorded camera wavefront (262,144 lanes) and
     merged bounce-1 wavefront (1,048,576 lanes): first the dense kernel
     against the plain sweep `dense_trace._sweep` on the same CUDA tensors,
     t and prim bit for bit (`dense_sweep.kernel_vs_plain`: the kernel's
     ms, the plain sweep's, the (warp, group) pairs its cull tested, the
     bounds and the shares), then
     `dense_trace.trace_shaded` and, called directly, `trace_clustered` on
     the same scene's cluster
     tables — misses equal, t within rtol 1e-5, every differing prim id a
     t-tie, and those not between coincident copies of one triangle
     (sphere.obj holds each triangle three times; the dense sweep reports
     the lowest index, the cluster tracer the first in its sweep order) at
     most 0.1% of hits, phase 3's bar; both times (CUDA events after a
     warm-up) and each tracer's kernel's alone;
 14. cornell_box at 512^2, `render_film_frames` with its schedule and NEE,
     CORNELL_FRAMES frames; 15. sky_dome and 16. spectral_box at 512^2,
     `render_film_frames_spec` with their schedules, SPEC_FRAMES frames
     each: phase 12's checks (a spectral HDR may be negative in a channel:
     XYZ -> sRGB of an out-of-gamut colour);
 17. the same 32^2 render on CUDA and on the CPU for each of the four
     scenes, as in phase 5;
 18. prism_rainbow (3,154 prims: the dense tracer) at 512^2 under spectral
     BDPT, unsliced, as the CLI renders it, with the scene's walk
     compaction and shadow cap 0.09: a warm-up frame, then PRISM_FRAMES
     timed frames; zero overflow (walk compaction plus capped shadow
     lanes), a finite HDR with mean > 0 (a spectral HDR may be negative in
     a channel), no launch of the cluster kernel, launches of the dense
     kernel, ms/frame and the peak
     device memory; one frame rendered twice from one key, bit-equal; and
     the same frame without the cap: its overflow, its time and peak
     memory, and whether it equals the capped frame bit for bit (else the
     two image sums);
 19. prism's two largest wavefronts, recorded at the integrator's calls of
     the tracer: the fused depth-1 walk (524,288 lanes) and the shadow
     batch packed to its capacity (471,936 lanes, with per-lane tmax) —
     the kernel vs cluster_trace_plain in sorted mode with phase 3's bar,
     then the dense kernel vs the plain sweep and the dense tracer vs
     `trace_clustered` with phase 13's bars; the
     dense sweep ignores tmax and the cluster tracer honours it, so the
     shadow batch is compared on the dense hits within the bound, which is
     what its caller reads (a hit within rtol 1e-5 of its bound may fall
     on either side: counted, at most 0.1% of the lanes);
 20. the same 32^2 prism render on CUDA and on the CPU, as in phase 5;
 21. the LBVH of the benchmark scene (100,800 triangles + the sphere light)
     built on CUDA by `accel/lbvh.build_lbvh_device`, bit-equal to the same
     build on the CPU (sorted order, children, every leaf and internal box),
     then flattened on the host: containment, coverage, and the threaded
     arrays equal to `build_host`'s `bvh_*`; the device build's ms (a first
     call, then a warm one), the flatten's ms, the tree height (the fit's
     fixpoint steps) and the node count;
 22. the kernel against an independent oracle, the BVH traversal
     (`accel/traverse.trace_closest` on CUDA over the scene's own tree),
     on four wavefronts recorded above: the bench's camera wavefront (phase
     3, shared origin), its bounce 1-2 wavefront (838,848 lanes, per-tile
     order), veach_pt's bounce 1 (phase 6, sorted) and veach_bdpt's shadow
     batch (phase 9, 2,621,440 lanes, per-lane tmax), each traced whole
     by `accel.trace_shaded` / `accel.trace` (the kernel and its sphere
     tail) and by the oracle, every lane (each wavefront takes the oracle
     0.5-1.2 s on the H100, 2,621,440 lanes included); then the dense
     kernel (through `dense_trace.trace_planar`) against the oracle on the
     six wavefronts of phase 25, off ties (prim ids that differ on a t-tie
     are not counted: the dense tracer's tie rule is the lowest index).  Bar (`_oracle_check`):
     |dt| within 1e-5 of max(t, |o|) (a shadow ray leaving a surface
     rounds t against its origin's magnitude; grazing hits beyond it
     counted: at most 0.1% of hits, each within 1e-3), prim ids equal but
     on t-ties (each differing lane re-intersected by the oracle: both
     prims at one distance, or the kernel's prim hit at its edge; at most
     0.2% of hits), misses equal but at an edge (a hit
     against a miss only where the ray passes within 1e-4 (barycentric)
     of the prim's boundary, at most 1e-4 of the lanes); for the tmax batch the same,
     an oracle hit beyond the bound counting as a miss, and a hit within
     rtol 1e-5 of its bound, which may fall on either side, counted (at
     most 0.1% of the lanes).  `trace_brute_force` on a BRUTE_LANES-lane subset of
     each is held against both with the same bar.  Per wavefront: the
     oracle's ms and iterations, the kernel's ms (CUDA events) and the
     peak device memory;
 23. the native host runtime (`io/native.py`): native/tiray_native.cpp
     built with g++ and loaded (a None fails), `load_obj`'s native parse
     equal to the Python parser on Teapot.obj, bdpt.obj and cornell_box.obj,
     `morton3d_native` against `utils/morton.morton3d` on the bench's
     centroids (at most 0.1% of codes one cell over: the native code
     multiplies by the reciprocal extent), and one 32^2 CLI run of the
     benchmark (`examples/run.py`, two merged dispatches) whose JSON line
     carries `metrics.RenderMeter.report()`'s fields.
 24. sharded rendering (`parallel/dryrun.dryrun_multichip`): 2 ranks
     spawned once on the one card (gloo, CUDA tensors), every section at
     512^2 — the merged bench path (`render_film_frames_merged_sharded`,
     benchmark_100k, KF=16 in one merged group of 16, the bench schedule;
     0 overflow kills and kernel launches on each rank), Veach BDPT
     (`render_bdpt_frame_sharded`, MAX_DEPTH 5), cornell_box PT
     (`render_frame_sharded` with `pt_rgb.trace_paths`), sky_dome spectral
     PT (`render_frame_spec_sharded`) and prism_rainbow spectral BDPT
     (`render_bdpt_spec_frame_sharded`), 1 frame each; each rank's image
     bit-equal to the parent's per-shard mirror (the shards rendered one
     after the other in this process), finite and not black; the Veach
     frame against the production `bdpt_rgb.render_frame_sliced` in 2
     slices (expected bit-equal; at most SHARD_PIXEL_FRAC of the pixels
     beyond rtol 1e-5: the ranks trace eye and light walks apart, and a
     t-tie may resolve otherwise in another wavefront); the kernel vs
     cluster_trace_plain on a rank's camera slice (131,072 lanes of the
     morton order, shared origin) with phase 3's bar; then the merged
     section on 1 rank over NCCL.  Per section the ranks' ms/frame, the
     mirror's, the ranks' start-up seconds and one all_reduce of the
     image's size per rank (recorded, not gated).  The sections on dense
     scenes (cornell_box, sky_dome, prism) must launch the dense kernel
     on each rank and never the cluster kernel; every section must launch
     the threefry kernel on each rank;
 25. dense kernel: cornell_box's (36 prims, two groups) and sky_dome's
     512^2 camera wavefronts, recorded in phases 14 and 15, through phase
     13's comparison; then the six wavefronts of phases 13, 19 and 25,
     each with its path's dense-kernel launches per frame at its width,
     the kernel's ms, the plain sweep's, the (warp, group) pairs tested
     (the kernel's own counts) and the share culled, the bound of the
     work the kernel did (`dense_sweep.work_counts`: each part at its
     instruction count in the kernel's SASS, tools/sass.py, on the pipes
     that run it) with the kernel's share of it, two bounds of the
     brute-force work it no longer does (the FP32 peak; the SASS count),
     for context, and the cluster tracer's ms; any differing bit fails;
 26. rng kernel: the threefry kernel (through `rng.uniform`) against
     `rng.uniform_plain` on the same CUDA device, bit for bit, on every
     shape the paths draw at 512^2 (RNG_SHAPES) and at every other
     element count the path phases' counted runs recorded; on each of
     RNG_SHAPES, after a line with `torch.rand`'s time for context
     (Philox, another function), the kernel's ms (CUDA events over
     RNG_REPS raw launches into one buffer), the wrapper's ms per call
     as the paths call it, the plain twin's ms, the bound (`_rng_bound`:
     75 integer operations per element, the 43 shifts and logic ops at
     64 per clock on the ALU pipe, all 75 at 128 issued per clock, on 132
     SMs at the maximum SM clock, against 4 bytes written per element at
     3.35 TB/s) and the share; any differing bit fails;
 27. disney kernel: csrc/disney.cu's two entry points (evaluate_pdf, with
     true_pdf off and on, and sample) against the plain twins
     (bsdf/planar.disney_evaluate_pdf_plain, disney_sample_plain) on the
     card, bit for bit (NaN-aware), on random lanes at DISNEY_WIDTHS; per
     entry and width the kernel's us per launch (its device time under
     torch.profiler over DISNEY_REPS wrapper calls), the wrapper's us per
     call (CUDA events over the same calls), the plain twin's ms, the
     bound (44 B read and 8 or 12 B written a lane at 3.35 TB/s) and the
     share; then the launches a frame of each path phase's counted run (from
     the spans: a pt_rgb path launches the shading kernel and no
     Disney kernel, every other path both Disney entries);
 28. pt shade kernel: csrc/pt_shade.cu (integrators/pt_rgb._shade on the
     card) against the plain twin _shade_plain bit for bit (NaN-aware) on
     random lanes at SHADE_WIDTHS, its one launch without NEE ("full") and
     its head and tail under NEE (the light sample and shadow prims given);
     per entry and width the kernel's us per launch (device time under
     torch.profiler over SHADE_REPS calls), the wrapper's us per call (CUDA
     events), the plain twin's ms, the bound (SHADE_BYTES a lane at 3.35
     TB/s) and the share; the wrapper's host us a call at SHADE_HOST_LANES
     lanes; then each pt_rgb path's launches a frame;
 29. coherence key kernel: csrc/coherence_key.cu (ops/cluster_trace.
     sort_key on the card) against its plain twin bit for bit, the key and
     its stable order, on lanes of every kind about each cluster path's
     scene box at every width the counted runs of phases 4 (the merged
     batch and one 1-frame preview call), 7 and 10 keyed, padded with an
     `active` mask and with an `alive` mask; at each path's widest the
     kernel's us a launch (device time under torch.profiler), the order's
     ms a call, the plain twin's, the bound (ORDER_BYTES a lane at 3.35
     TB/s) and the share; the host us a call of each route.

Every wavefront is recorded at the tracer's call of the kernel
(tools/kernel_wavefronts.py), and the plain version runs on blocks of
PLAIN_TILES tiles to bound its memory.  The next-to-last line is a JSON
object describing the cluster kernel (launches summed over the counted runs of
the three paths that reach it and over the ranks of phase 24, max_abs_err
the worst over every compared wavefront, ms,
plain_ms and bound_ms of the bench camera wavefront, and each compared
wavefront's figures with its width's launches per frame in its path's
counted run, and phase 22's agreement with the oracle per wavefront)
and the dense kernel (launches summed over the counted runs of phases
12, 14-16 and 18 and over the ranks of phase 24, max_abs_err over phase
25's six wavefronts, ms, plain_ms and bound_ms of single_model's camera
wavefront, the six rows with their counts and bounds, and phase 22's
agreement with the oracle per wavefront) and the threefry kernel (launches summed
over the counted runs of phases 4, 7, 10, 12, 14-16 and 18 and over the
ranks of phase 24, max_abs_err over phase 26's shapes, ms, plain_ms and
bound_ms of the (8, 262,144) draw, each shape's row and each path's draws
per frame) and the Disney kernels, the PT shading kernel and the
coherence key kernel (launches summed over the counted runs, each entry's
or path's rows, each path's launches per frame); the last
line is {"ok": true, "device": {...}}.
Without CUDA, or without the package beside it, the script exits
non-zero and prints no result.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

SIZE = 512
KF = 16          # frames per dispatch
GROUP = 16       # frames per merged group
TIMED_DISPATCHES = 2
KERNEL_REPS = 10  # timed kernel launches per compared wavefront
SMALL = 32       # phase 5 and 8 film size
VEACH_FRAMES = 8
BDPT_FRAMES = 4
DENSE_GROUPS = 1  # timed single_model groups of 16 frames
CORNELL_FRAMES = 8
SPEC_FRAMES = 4
PRISM_FRAMES = 2
SHARD_RANKS = 2  # phase 24: ranks on the one card
SHARD_TIMEOUT = 300.0  # s: the ranks' join, rendezvous and collective limit
SHARD_PIXEL_FRAC = 1e-3  # Veach 2-rank vs sliced: pixels allowed beyond rtol 1e-5
DENSE_REPS = 3   # timed traces per tracer in phase 13
PLAIN_TILES = 1024  # tiles per block of the plain version
DENSE_SECTIONS = ("pt", "pt_spec", "bdpt_spec")  # phase 24's sections on dense scenes
T_RTOL = 1e-5
PRIM_TIE_FRAC = 1e-3
ORACLE_TIE_FRAC = 2e-3  # prim mismatches against the BVH oracle, share of hits
BRUTE_LANES = 4096
# phase 26: every shape the paths draw at 512^2 (camera jitter, a PT bounce
# at the camera width, the bench's merged bounce 1-2 width, single_model's
# merged bounce 1, BDPT's walk step, light sample and strategy draws,
# pt_spec's wavelength draw), each timed
RNG_SHAPES = ((2, 262144), (8, 262144), (8, 838848), (8, 1048576), (5, 262144),
              (6, 131072), (3, 2621440), (262144,))
RNG_REPS = 100  # timed launches per shape
# per SM and clock: 64 lanes of the integer ALU pipe (shifts, logic, adds),
# 64 of the FMA pipe (IMAD, which takes the adds the compiler moves there),
# 128 issued in all (kernel_wavefronts.ISSUE_PER_CLOCK)
ALU_PER_CLOCK = 64
RNG_RUNS = []  # (path, rng kernel launches, launches per frame by elements drawn)
# phase 27: the Disney kernels at the main paths' widths (a 512^2 frame's
# lanes, and half of them: a BDPT slice), timed over DISNEY_REPS calls
DISNEY_WIDTHS = (131072, 262144)
DISNEY_REPS = 100
DISNEY_BYTES = {"eval": (44, 8), "eval_true_pdf": (44, 8), "sample": (44, 12)}  # read, written
DISNEY_RUNS = []  # (path, frames, Disney kernel launches by entry)
# phase 28: the shading kernel at the PT paths' widths (a 512^2 frame's
# lanes, and a merged group's 1,048,576), timed over SHADE_REPS calls; the
# wrapper's host cost at SHADE_HOST_LANES, where the launch is no wait
SHADE_WIDTHS = (262144, 1048576)
SHADE_REPS = 50
SHADE_HOST_LANES = 1024
# bytes a lane (read, written): csrc/pt_shade.cu's header
SHADE_BYTES = {"full": (198, 78), "head": (37, 13), "tail": (250, 78)}
SHADE_RUNS = []  # (path, frames, shading kernel launches by entry)
# phase 29: the coherence key kernel at every width the cluster paths keyed
# (ORDER_RUNS), timed at the widest of each path over ORDER_REPS launches;
# 24 B read (o, d), 1 B (a mask) and 8 B written a lane
ORDER_RUNS = []  # (path, frames, key kernel launches by lanes keyed)
ORDER_REPS = 50
ORDER_BYTES = 33
ORDER_HOST_LANES = 1024
# a hit against a miss, or against another prim at one t, is an edge case
# where the ray passes within this barycentric distance of the prim's
# boundary by the oracle's arithmetic: the kernel's shared-origin form
# rounds barycentrics by ~1.2e-5 (two edge hits of the bench camera
# wavefront, on the H100)
EDGE_MARGIN = 1e-4


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


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
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if clock.returncode != 0:
        fail(f"nvidia-smi: {clock.stderr.strip()}")
    sm_max, sm_now = (float(x) for x in clock.stdout.strip().splitlines()[0].split(","))
    log(f"[1 device] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; SM clock "
        f"{sm_now:g} MHz now, {sm_max:g} MHz max")
    return sm_max


def phase_build():
    """The six kernel sources built at once, one nvcc per source, beside
    the dense kernel's SASS probes."""
    from concurrent.futures import ThreadPoolExecutor

    from ti_raytrace_tpu_torch.bsdf.planar import DISNEY_KERNEL
    from ti_raytrace_tpu_torch.core.rng import UNIFORM_KERNEL
    from ti_raytrace_tpu_torch.integrators.pt_rgb import SHADE_KERNEL
    from ti_raytrace_tpu_torch.ops.cluster_trace import COHERENCE_KERNEL, KERNEL
    from ti_raytrace_tpu_torch.ops.dense_trace import DENSE_KERNEL
    from ti_raytrace_tpu_torch.tools import sass

    kernels = (KERNEL, DENSE_KERNEL, UNIFORM_KERNEL, DISNEY_KERNEL, SHADE_KERNEL,
               COHERENCE_KERNEL)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        probes = pool.submit(sass.dense_counts)
        list(pool.map(lambda k: k.library(), kernels))
        parts = probes.result()
    log(f"[2 build] {len(kernels)} kernels and the probes in {time.perf_counter() - t0:.2f} s")
    for part, counts in parts.items():
        log(f"[2 build] dense_trace.cu SASS, {part}: {counts}")
    for k in kernels:
        source, info = k.SOURCE, k.build_info
        log(f"[2 build] {source}: nvcc {info.seconds:.2f} s, built={info.built} -> {info.path}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2 build] {source} ptxas: {line.strip()}")


def _plain_blocks(inputs, tiles, stats):
    """cluster_trace_plain over blocks of `tiles` ray tiles (the order
    rows of a per-tile order go with their tiles), concatenated: the
    same result as one call, with bounded temporaries."""
    import torch

    from ti_raytrace_tpu_torch.ops.cluster_trace import TILE, cluster_trace_plain

    o, d, n_valid, bounds, order, tri, origin_mt, tmax, supers = inputs
    n_pad = o.shape[1]
    step = tiles * TILE
    outs = []
    for a in range(0, n_pad, step):
        b = min(n_pad, a + step)
        rows = order if order.shape[0] == 1 else order[a // TILE:b // TILE]
        outs.append(cluster_trace_plain(
            o[:, a:b], d[:, a:b], min(max(n_valid - a, 0), b - a), bounds, rows, tri,
            origin_mt, None if tmax is None else tmax[a:b], supers, stats=stats))
    return tuple(torch.cat(x) for x in zip(*outs))


def _compare(name, inputs, tag):
    """Kernel vs plain version on one wavefront: the bar of phase 3, then
    a row of the wavefront's figures (times, visits, candidate pairs, the
    bound and its share)."""
    import torch

    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import bound, time_ms

    ms_k, (t_k, p_k, u_k, v_k, vis_k) = time_ms(lambda: KERNEL(*inputs), KERNEL_REPS)
    stats = {}
    t0 = time.perf_counter()
    t_p, p_p, u_p, v_p, vis_p = _plain_blocks(inputs, PLAIN_TILES, stats)
    torch.cuda.synchronize()
    ms_p = (time.perf_counter() - t0) * 1e3
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
    pairs, entries = int(stats["pairs"]), int(stats["super_entries"])
    bound_ms, bound_by, ops, nbytes = bound(inputs, pairs, entries)
    row = dict(wavefront=name, lanes=n, ms=ms_k, plain_ms=ms_p,
               visited_per_tile=float(vis_k.float().mean()), pairs=pairs,
               super_entries=entries, ops=ops, bytes=nbytes, bound_ms=bound_ms,
               bound_by=bound_by, share=bound_ms / ms_k)
    log(f"{tag} {name}: {n} lanes, {n_hit} hits; max|dt| {max_dt:.3e} "
        f"(rtol {T_RTOL} ok={t_ok}); prim mismatch {frac:.2e} of hits "
        f"(ties ok={ties_ok}); misses equal={miss_ok}; max|duv| {duv:.3e}; "
        f"visited equal={vis_ok}")
    log(f"{tag} {name}: kernel {ms_k:.4f} ms, plain {ms_p:.3f} ms; "
        f"{row['visited_per_tile']:.2f} clusters visited per tile; {pairs} candidate "
        f"pairs; {entries} super-box entries; bound {bound_ms:.4f} ms by {bound_by} "
        f"({ops:.4g} ops, {nbytes} B); share {row['share']:.4f}")
    if not (n_hit > 0 and t_ok and frac <= PRIM_TIE_FRAC and ties_ok and miss_ok and vis_ok):
        fail(f"kernel disagrees with cluster_trace_plain on the {name} wavefront")
    return max_dt, row


def _compare_all(waves, tag):
    """_compare on each recorded wavefront.  Returns (max |dt|, rows)."""
    import torch

    errs, rows = [], []
    for name, inputs in waves:
        err, row = _compare(name, inputs, tag)
        errs.append(err)
        rows.append(row)
    del waves
    torch.cuda.empty_cache()
    return max(errs), rows


def phase_kernel(scene, spec, cam, cfg):
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import bench_wavefronts

    waves, _ = bench_wavefronts(scene, spec, cam, cfg)
    if [a[2] for _, a in waves] != [SIZE * SIZE, 838848, 174752, 32768]:
        fail(f"one merged group launched the widths {[a[2] for _, a in waves]}")
    return (*_compare_all(waves, "[3 kernel]"), waves[:2])


def _log_widths(tag, per_width, frames, kernel="kernel"):
    """Logs and returns the counted run's kernel launches per frame by
    live width (`_counted`'s)."""
    per_frame = {w: c / frames for w, c in per_width.items()}
    log(f"{tag} {kernel} launches per frame by live width: " + ", ".join(
        f"{w}: {c:g}" for w, c in sorted(per_frame.items(), reverse=True)))
    return per_frame


def _attach_launches(rows, per_frame):
    """Each compared wavefront's row gains its width's launches per frame
    in its path's counted run (none launched: 0)."""
    for row in rows:
        row["launches_per_frame"] = per_frame.get(row["lanes"], 0.0)


@contextlib.contextmanager
def _counted():
    """A counted run: the block records its spans (metrics.recording, a few
    us of host time a span; the dense sweep runs its counting variant), and
    the dict it yields then holds each hand kernel's launches in the block,
    read from those spans
    (metrics.kernel_launches): "cluster" by live width, "dense" and "rng" by
    lanes, "disney" by op, "shade" by entry, "order" (the coherence key) by
    lanes keyed."""
    from ti_raytrace_tpu_torch import metrics

    metrics.clear_spans()
    counts = {}
    with metrics.recording():
        yield counts
    for key, name, by in (("cluster", "trace.kernel", "n_valid"),
                          ("dense", "dense_trace._sweep", "n"), ("rng", "rng.uniform", "n"),
                          ("disney", "bsdf.disney", "op"), ("shade", "pt.shade", "entry"),
                          ("order", "trace.order", "n")):
        counts[key] = metrics.kernel_launches(name, by)
    metrics.clear_spans()


def _rng_counts(tag, path, frames, counts):
    """The threefry kernel's launches by elements drawn, counts["rng"], in a
    counted run (`_counted`'s, whose Disney and shading launches
    `_disney_counts` logs first; or a phase 24 rank's): logs its draws per
    frame by elements drawn, fails if it never launched, records the run in
    RNG_RUNS."""
    if "disney" in counts:
        _disney_counts(tag, path, frames, counts)
    per_width = counts["rng"]
    launches = sum(per_width.values())
    per_frame = {w: c / frames for w, c in per_width.items()}
    log(f"{tag} rng kernel: {launches} launches ({launches / frames:g} draws per frame); by "
        f"elements drawn: " + ", ".join(f"{w}: {c:g}" for w, c in sorted(per_frame.items(),
                                                                           reverse=True)))
    if launches == 0:
        fail(f"the {path} path never launched the threefry kernel")
    RNG_RUNS.append((path, launches, per_frame))
    if counts.get("order"):
        order = counts["order"]
        log(f"{tag} coherence key kernel: {sum(order.values())} launches "
            f"({sum(order.values()) / frames:g} per frame) over {len(order)} widths")
        ORDER_RUNS.append((path, frames, dict(order)))


def _disney_counts(tag, path, frames, counts):
    """The Disney and shading kernels' launches in a counted run
    (`_counted`'s): logs them per frame and records the run in DISNEY_RUNS
    and SHADE_RUNS.  A pt_rgb path shades through
    csrc/pt_shade.cu and makes no Disney dispatch; the others dispatch the
    Disney BSDF.  Fails if a path launched neither the shading kernel nor
    both Disney kernels, or both."""
    launches = dict(counts["disney"])
    shade = dict(counts["shade"])
    log(f"{tag} disney kernel: " + ", ".join(
        f"{op} {launches.get(op, 0)} launches ({launches.get(op, 0) / frames:g} per frame)"
        for op in ("eval", "sample")) + "; pt shade kernel: " + ", ".join(
        f"{op} {shade.get(op, 0)} launches ({shade.get(op, 0) / frames:g} per frame)"
        for op in ("full", "head", "tail")))
    disney = bool(launches.get("eval") and launches.get("sample"))
    if disney == bool(shade):
        fail(f"the {path} path launched {launches} Disney and {shade} shading kernels: one "
             "of the two, not both")
    if disney:
        DISNEY_RUNS.append((path, frames, launches))
    else:
        SHADE_RUNS.append((path, frames, shade))


def phase_main_path(scene, spec, cam, cfg, sync):
    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import render_batch
    from ti_raytrace_tpu_torch.integrators import pt_rgb

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

    times = []
    with _counted() as counts:  # count only the timed main-path run below
        for _ in range(TIMED_DISPATCHES):
            t0 = time.perf_counter()
            fl, ov = dispatch(fl)
            sync()
            times.append(time.perf_counter() - t0)
            kills += ov
    per_width = counts["cluster"]
    launches = sum(per_width.values())
    hdr = fl.hdr
    ok_img = (tuple(hdr.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(hdr).all())
              and bool((hdr >= 0).all()) and float(hdr.mean()) > 0.0)
    ms = [t / KF * 1e3 for t in times]
    log(f"[4 main] {SIZE}^2 merged G={GROUP}, {TIMED_DISPATCHES} timed dispatches of "
        f"{KF} frames: ms/frame " + ", ".join(f"{m:.3f}" for m in ms)
        + f" (mean {sum(ms) / len(ms):.3f}); overflow kills {kills}; kernel launches "
        f"{launches} ({launches / (TIMED_DISPATCHES * KF):g} per frame); frames {fl.frame}; "
        f"hdr mean {float(hdr.mean()):.5f}")
    per_frame = _log_widths("[4 main]", per_width, TIMED_DISPATCHES * KF)
    _rng_counts("[4 main]", "bench", TIMED_DISPATCHES * KF, counts)
    with _counted() as counts:  # one update of the preview: a 1-frame call
        render_batch(scene, cfg, spec, cam, fl, 1, "pt_rgb", cfg.group or 0)
        sync()
    _rng_counts("[4 preview]", "bench_preview", 1, counts)
    if kills != 0:
        fail(f"{kills} compaction overflow kills on the main path")
    if not ok_img:
        fail("the main path's HDR is not a finite, non-negative (W, H, 3) image")
    if launches == 0:
        fail("the main path never launched the cluster_trace kernel")
    return launches, per_frame


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


def phase_veach_kernel(scene, spec, cam):
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import veach_wavefronts

    waves, _ = veach_wavefronts(scene, spec, cam)
    return (*_compare_all(waves, "[6 veach kernel]"), waves[1])


def phase_veach_path(scene, spec, cam, cfg, sync):
    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    nee = pt_rgb.has_nee_materials(scene)
    if not nee:
        fail("the Veach scene has no material that takes NEE")
    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    t0 = time.perf_counter()
    with _counted() as counts:  # count only this path's run
        fl, kills = pt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=VEACH_FRAMES,
                                              compaction=cfg.compaction, nee=nee)
        sync()
    seconds = time.perf_counter() - t0
    per_width = counts["cluster"]
    launches = sum(per_width.values())
    hdr = fl.hdr
    ok_img = (tuple(hdr.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(hdr).all())
              and bool((hdr >= 0).all()) and float(hdr.mean()) > 0.0)
    log(f"[7 veach] veach_pt {SIZE}^2, max depth {pt_rgb.MAX_DEPTH}, NEE, exact path: "
        f"{VEACH_FRAMES} frames in {seconds:.2f} s = {seconds / VEACH_FRAMES * 1e3:.3f} "
        f"ms/frame; overflow kills {kills}; kernel launches {launches} "
        f"({launches / VEACH_FRAMES:g} per frame); hdr mean {float(hdr.mean()):.5f}")
    per_frame = _log_widths("[7 veach]", per_width, VEACH_FRAMES)
    _rng_counts("[7 veach]", "veach_pt", VEACH_FRAMES, counts)
    if kills != 0:
        fail(f"{kills} overflow kills on the veach_pt path")
    if not ok_img:
        fail("the veach_pt HDR is not a finite, non-negative (W, H, 3) image")
    if launches == 0:
        fail("the veach_pt path never launched the cluster_trace kernel")
    return launches, per_frame


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


def phase_bdpt_kernel(scene, spec, cam):
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import bdpt_wavefronts

    waves, widths = bdpt_wavefronts(scene, spec, cam)
    if widths.count(SIZE * SIZE // 2 * 20) != 2 or waves[0][1][7] is not None:
        fail(f"one BDPT frame launched the widths {widths}")
    return (*_compare_all(waves, "[9 bdpt kernel]"), waves[1])


def phase_bdpt_path(scene, spec, cam, cfg, sync):
    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    def frames(fl, n):
        return bdpt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=n, n_slices=2,
                                           walk_compaction=cfg.bdpt_walk_compaction,
                                           shadow_cap=cfg.bdpt_shadow_cap)

    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    t0 = time.perf_counter()
    fl, overflow = frames(fl, 1)  # warm-up
    sync()
    log(f"[10 bdpt] warm-up frame {time.perf_counter() - t0:.2f} s, overflow {overflow}")
    t0 = time.perf_counter()
    with _counted() as counts:  # count only the timed run below
        fl, ov = frames(fl, BDPT_FRAMES)
        sync()
    seconds = time.perf_counter() - t0
    per_width = counts["cluster"]
    launches = sum(per_width.values())
    overflow += ov
    hdr = fl.hdr
    ok_img = (tuple(hdr.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(hdr).all())
              and bool((hdr >= 0).all()) and float(hdr.mean()) > 0.0)
    log(f"[10 bdpt] veach_bdpt {SIZE}^2, MAX_DEPTH {bdpt_rgb.MAX_DEPTH}, 2 slices: "
        f"{BDPT_FRAMES} frames in {seconds:.2f} s = {seconds / BDPT_FRAMES * 1e3:.3f} "
        f"ms/frame; walk overflow {overflow}; kernel launches {launches} "
        f"({launches / BDPT_FRAMES:g} per frame); hdr mean {float(hdr.mean()):.5f}")
    per_frame = _log_widths("[10 bdpt]", per_width, BDPT_FRAMES)
    _rng_counts("[10 bdpt]", "veach_bdpt", BDPT_FRAMES, counts)
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
    return launches, per_frame


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


def _dense_path(tag, name, scene, cfg, spec, cam, fl, frames, sync, warm_kills, sdata=None):
    """`frames` timed frames of one dense-tracer scene into `fl`, rendered
    as the CLI renders it (`sdata`: the spectral tables of a pt_spec
    scene), with the checks of the path phases.  The scene must not reach
    the cluster kernel and must launch the dense one.  Returns (dense
    kernel launches, their launches per frame by width)."""
    import torch

    from ti_raytrace_tpu_torch.tools.dense_sweep import render_frames

    t0 = time.perf_counter()
    with _counted() as counts:
        fl, kills = render_frames(scene, cfg, spec, cam, fl, frames, sdata)
        sync()
    seconds = time.perf_counter() - t0
    cluster, dense = sum(counts["cluster"].values()), sum(counts["dense"].values())
    kills += warm_kills
    hdr = fl.hdr
    # XYZ -> sRGB leaves out-of-gamut spectral colours negative in a channel
    signed = cfg.integrator in ("pt_spec", "bdpt_spec")
    ok_img = (tuple(hdr.shape) == (SIZE, SIZE, 3) and bool(torch.isfinite(hdr).all())
              and (signed or bool((hdr >= 0).all())) and float(hdr.mean()) > 0.0)
    log(f"{tag} {name} {SIZE}^2, {cfg.integrator}, {scene.n_prims} prims, schedule "
        f"{cfg.compaction}, group {cfg.group}: {frames} frames in {seconds:.2f} s = "
        f"{seconds / frames * 1e3:.3f} ms/frame; overflow kills {kills}; cluster kernel "
        f"launches {cluster}; dense kernel launches {dense} "
        f"({dense / frames:g} per frame); frames {fl.frame}; hdr mean "
        f"{float(hdr.mean()):.5f}")
    per_frame = _log_widths(tag, counts["dense"], frames, "dense kernel")
    _rng_counts(tag, name, frames, counts)
    if kills != 0:
        fail(f"{kills} compaction overflow kills on the {name} path")
    if not ok_img:
        fail(f"the {name} HDR is not a finite (W, H, 3) image with mean > 0"
             + ("" if signed else ", or has a negative value"))
    if cluster != 0:
        fail(f"{name} ({scene.n_prims} prims) reached the cluster kernel")
    if dense == 0:
        fail(f"{name} ({scene.n_prims} prims) never launched the dense kernel")
    return dense, per_frame


def _dense_rows(tag, scene, waves, reps, per_frame, sm_mhz, tmax=()):
    """`dense_sweep.compare` on each (name, o, d, shared origin) wavefront
    of `scene`: a line of the dense kernel against the plain sweep per
    wavefront (any differing bit of t or prim fails the run), its path's
    dense-kernel launches per frame at the wavefront's width, and the
    comparison's row."""
    from ti_raytrace_tpu_torch.tools.dense_sweep import compare

    rows = []
    for i, (name, o, d, origin) in enumerate(waves):
        r = compare(scene, o, d, origin, reps, sm_mhz, tmax=tmax[i] if tmax else None)
        r.update(wavefront=name, launches_per_frame=per_frame.get(r["lanes"], 0.0))
        log(f"{tag} dense kernel vs plain sweep, {name}: {r['lanes']} lanes x {r['prims']} "
            f"prims; bit-equal t and prim={r['bit_equal']}; kernel {r['kernel_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.3f} ms; {r['tested']} of {r['pairs']} (warp, group) pairs "
            f"tested (culled {r['culled_frac']:.4f}); {r['launches_per_frame']:g} launches per "
            f"frame")
        if not r["bit_equal"]:
            fail(f"the dense kernel differs from the plain sweep on the {name} wavefront")
        rows.append(r)
    return rows


def phase_single_model(sync, sm_mhz):
    """Phase 12, then phase 13 on the wavefronts its warm-up group recorded.
    Returns (dense kernel launches, phase 13's rows, phase 22's wavefronts:
    [(path, name, scene, o, d, tmax)])."""
    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.scenes import make_camera, single_model
    from ti_raytrace_tpu_torch.tools.dense_sweep import group_wavefronts

    scene, cfg = single_model("cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    t0 = time.perf_counter()
    waves, fl, warm_kills = group_wavefronts(scene, cfg, spec, cam, fl)
    sync()
    log(f"[12 single_model] warm-up group: {cfg.group} frames in "
        f"{time.perf_counter() - t0:.2f} s, overflow kills {warm_kills}")
    launches, per_frame = _dense_path("[12 single_model]", "single_model", scene, cfg, spec,
                                      cam, fl, DENSE_GROUPS * cfg.group, sync, warm_kills)

    if [w[1].shape[1] for w in waves] != [SIZE * SIZE, cfg.group * SIZE * SIZE // 4]:
        fail(f"one single_model group traced the widths {[w[1].shape[1] for w in waves]}")
    rows = _dense_rows("[13 dense vs cluster]", scene, waves, DENSE_REPS, per_frame, sm_mhz)
    for (name, _, _, _), r in zip(waves, rows):
        log(f"[13 dense vs cluster] {name}: {r['lanes']} lanes x {r['prims']} prims, "
            f"{r['hits']} hits; misses equal={r['misses_equal']}; max|dt| "
            f"{r['max_abs_dt']:.3e} (rtol {T_RTOL} ok={r['t_ok']}); prim mismatch "
            f"{r['prim_mismatch_frac']:.2e} of hits, {r['apart_mismatch_frac']:.2e} not "
            f"between coincident copies (ties ok={r['ties_ok']})")
        log(f"[13 dense vs cluster] {name}: dense tracer {r['dense_ms']:.3f} ms (its kernel "
            f"alone {r['kernel_ms']:.4f} ms), cluster tracer {r['cluster_ms']:.3f} ms (its "
            f"kernel alone {r['cluster_kernel_ms']:.4f} ms)")
        if not (r["hits"] > 0 and r["misses_equal"] and r["t_ok"] and r["ties_ok"]
                and r["apart_mismatch_frac"] <= PRIM_TIE_FRAC):
            fail(f"the dense sweep disagrees with the cluster tracer on the {name} wavefront")
    for r in rows:
        r["path"] = "single_model"
    return launches, rows, [("single_model", name, scene, o, d, None) for name, o, d, _ in waves]


def phase_dense_path(tag, name, frames, sync):
    """Phases 14-16: a warm-up frame, recorded at the dense tracer, then
    `frames` timed frames.  Returns (dense kernel launches, their launches
    per frame by width, (scene, o, d) of the warm-up frame's camera
    wavefront)."""
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import spectral_data
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera
    from ti_raytrace_tpu_torch.tools.dense_sweep import recording, render_frames

    scene, cfg = EXAMPLES[name]("cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    sdata = spectral_data(cfg, cfg.integrator, scene.device)
    with recording() as calls:
        fl, warm_kills = render_frames(scene, cfg, spec, cam, fl, 1, sdata)
    sync()
    o, d = calls[0]
    if o.shape[1] != SIZE * SIZE:
        fail(f"the first dense trace of a {name} frame has {o.shape[1]} lanes")
    del calls
    launches, per_frame = _dense_path(tag, name, scene, cfg, spec, cam, fl, frames, sync,
                                      warm_kills, sdata)
    return launches, per_frame, (scene, o, d)


def phase_dense_parity(name, phase=17):
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import spectral_data
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera
    from ti_raytrace_tpu_torch.tools.dense_sweep import render_frames

    def render(dev):
        scene, cfg = EXAMPLES[name](dev)
        spec, cam = make_camera(scene, cfg, SMALL, SMALL)
        fl, kills = render_frames(scene, cfg, spec, cam,
                                  film_mod.new_film(SMALL, SMALL, seed=3, device=dev), 2,
                                  spectral_data(cfg, cfg.integrator, dev))
        return fl.hdr, kills

    _small_parity(f"[{phase} {name} parity]", render)


def phase_prism(sync, sm_mhz):
    """Phase 18, then phase 19 on the wavefronts of one more frame.
    Returns (max |dt| of the kernel against its plain version, its rows,
    dense kernel launches, the dense kernel's rows, phase 22's wavefronts:
    [(path, name, scene, o, d, tmax)])."""
    import dataclasses

    import torch

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.examples.run import spectral_data
    from ti_raytrace_tpu_torch.examples.scenes import make_camera, prism_rainbow
    from ti_raytrace_tpu_torch.ops import cluster_trace as ct
    from ti_raytrace_tpu_torch.tools.dense_sweep import prism_wavefronts, render_frames

    tag = "[18 prism_rainbow]"
    scene, cfg = prism_rainbow("cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    render = spectral_data(cfg, cfg.integrator, scene.device)
    fl = film_mod.new_film(SIZE, SIZE, seed=0, device=scene.device)
    t0 = time.perf_counter()
    fl, warm = render_frames(scene, cfg, spec, cam, fl, 1, render)
    sync()
    log(f"{tag} warm-up frame {time.perf_counter() - t0:.2f} s, overflow {warm}; walk "
        f"compaction {cfg.bdpt_walk_compaction}, shadow cap {cfg.bdpt_shadow_cap}")
    torch.cuda.reset_peak_memory_stats()
    launches, per_frame = _dense_path(tag, "prism_rainbow", scene, cfg, spec, cam, fl,
                                      PRISM_FRAMES, sync, warm, render)
    peak = torch.cuda.max_memory_allocated()

    def timed(fn):
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()

    key = rng.PRNGKey(7)
    a, _, _ = timed(lambda: render(scene, spec, cam, 3, key))
    (b, ov_b), ms_capped, _ = timed(lambda: render(scene, spec, cam, 3, key,
                                                   return_overflow=True))
    same = bool(torch.equal(a, b))
    log(f"{tag} capped frames: peak memory {peak / 2 ** 20:.1f} MiB; one frame rendered "
        f"twice from one key: bit-equal={same} (mean {float(a.mean()):.5f}, "
        f"{ms_capped:.3f} ms, overflow {int(ov_b)})")
    uncapped = spectral_data(dataclasses.replace(cfg, bdpt_shadow_cap=None), cfg.integrator,
                             scene.device)
    uncapped(scene, spec, cam, 3, key)  # warm-up at the uncapped widths
    (u, ov_u), ms_uncapped, peak_u = timed(lambda: uncapped(scene, spec, cam, 3, key,
                                                            return_overflow=True))
    cap_equal = bool(torch.equal(u, a))
    log(f"{tag} the same frame without the shadow cap: {ms_uncapped:.3f} ms against "
        f"{ms_capped:.3f} ms capped; overflow {int(ov_u)}; peak memory "
        f"{peak_u / 2 ** 20:.1f} MiB; bit-equal to the capped frame={cap_equal}; image sums "
        f"{float(u.double().sum()):.6f} uncapped, {float(a.double().sum()):.6f} capped")
    if not same:
        fail("two renders of one prism frame from one key differ")
    if int(ov_b) != 0 or int(ov_u) != 0:
        fail(f"overflow on one prism frame: {int(ov_b)} capped, {int(ov_u)} uncapped")
    if not cap_equal and abs(float(u.double().sum()) / float(a.double().sum()) - 1.0) > 1e-3:
        fail("the shadow cap changed the prism frame though it cut no lane")
    del a, b, u

    tag = "[19 prism wavefronts]"
    waves, n_active = prism_wavefronts(scene, cfg, spec, cam)
    widths = [w[1].shape[1] for w in waves]
    log(f"{tag} recorded widths {widths}; {n_active} of the packed shadow batch's lanes "
        f"are active")
    if widths != [2 * SIZE * SIZE, 471936] or not 0 < n_active <= widths[1]:
        fail(f"one prism frame traced the widths {widths} with {n_active} active shadow lanes")
    kernel_waves = [(f"{name} (sorted)", ct.kernel_inputs(scene, o, d, True, tmax=tmax)[0])
                    for name, o, d, tmax in waves]
    max_err, rows = _compare_all(kernel_waves, tag)
    dense_rows = _dense_rows(tag, scene, [(name, o, d, None) for name, o, d, _ in waves],
                             DENSE_REPS, per_frame, sm_mhz, tmax=[w[3] for w in waves])
    for (name, o, d, tmax), r in zip(waves, dense_rows):
        r["path"] = "prism_rainbow"
        log(f"{tag} dense vs cluster, {name}: {r['lanes']} lanes x {r['prims']} prims, "
            f"{r['hits']} hits{'' if tmax is None else ' within the bound'}; misses equal="
            f"{r['misses_equal']}; max|dt| {r['max_abs_dt']:.3e} (rtol {T_RTOL} "
            f"ok={r['t_ok']}); prim mismatch {r['prim_mismatch_frac']:.2e} of hits (ties "
            f"ok={r['ties_ok']}); {r['at_bound']} lanes at their bound")
        log(f"{tag} dense vs cluster, {name}: dense tracer {r['dense_ms']:.3f} ms (its kernel "
            f"alone {r['kernel_ms']:.4f} ms), cluster tracer {r['cluster_ms']:.3f} ms (its "
            f"kernel alone {r['cluster_kernel_ms']:.4f} ms)")
        if not (r["hits"] > 0 and r["misses_equal"] and r["t_ok"] and r["ties_ok"]
                and r["prim_mismatch_frac"] <= PRIM_TIE_FRAC
                and r["at_bound"] <= PRIM_TIE_FRAC * r["lanes"]):
            fail(f"the dense sweep disagrees with the cluster tracer on prism's {name}")
    del kernel_waves
    torch.cuda.empty_cache()
    return (max_err, rows, launches, dense_rows,
            [("prism_rainbow", name, scene, o, d, tmax) for name, o, d, tmax in waves])


def phase_lbvh(sync):
    """Phase 21.  Returns the benchmark's host dict."""
    import numpy as np
    import torch

    from ti_raytrace_tpu_torch.accel import lbvh
    from ti_raytrace_tpu_torch.examples.scenes import benchmark_100k_cached_host
    from ti_raytrace_tpu_torch.scene.build import prim_bounds

    tag = "[21 lbvh]"
    host = benchmark_100k_cached_host()
    pmin, pmax = prim_bounds(host)
    args = [torch.from_numpy(np.asarray(x)) for x in (pmin, pmax, host["aabb_min"],
                                                      host["aabb_max"])]
    n = pmin.shape[0]
    gpu_args = [a.cuda() for a in args]
    ms = []
    for _ in range(2):  # a first call, then a warm one
        sync()
        t0 = time.perf_counter()
        gpu = lbvh.build_lbvh_device(*gpu_args)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cpu = lbvh.build_lbvh_device(*args)
    ms_cpu = (time.perf_counter() - t0) * 1e3
    keys = ("sorted_idx", "left", "right", "leaf_min", "leaf_max", "int_min", "int_max")
    equal = {k: bool(torch.equal(gpu[k].cpu(), cpu[k])) for k in keys}
    t0 = time.perf_counter()
    flat = lbvh.flatten_threaded(gpu)
    ms_flat = (time.perf_counter() - t0) * 1e3
    contained, covered = lbvh.check_containment(flat), lbvh.check_coverage(flat, n)
    same_host = all(flat[k].tobytes() == host[k].tobytes() for k in flat)
    log(f"{tag} {n} prims ({int((host['prim_type'] == 1).sum())} triangles): device build "
        f"{ms[0]:.3f} ms first call, {ms[1]:.3f} ms warm (CPU {ms_cpu:.1f} ms); tree height "
        f"{gpu['iterations']} fixpoint steps (CPU {cpu['iterations']}); {flat['bvh_prim'].shape[0]} "
        f"nodes; flatten {ms_flat:.1f} ms")
    log(f"{tag} CUDA tree bit-equal to the CPU's: {equal}; containment={contained}, "
        f"coverage={covered}; threaded arrays equal to build_host's bvh_*={same_host}")
    if n < 100_001 or not all(equal.values()) or gpu["iterations"] != cpu["iterations"]:
        fail("the LBVH built on CUDA differs from the CPU build")
    if not (contained and covered and same_host and flat["bvh_prim"].shape[0] == 2 * n - 1):
        fail("the flattened LBVH breaks an invariant or differs from build_host's")
    return host


def _edge_margin(scene, o, d, prim):
    """How far each ray passes from the boundary of its prim, by the
    oracle's own arithmetic: a triangle's least barycentric (u, v or
    1 - u - v, negative outside), a sphere's (r^2 - distance^2) / r^2
    (negative outside).  A hit and a miss of two tracers can differ only
    where this is ~0, at rounding distance from an edge."""
    import torch

    from ti_raytrace_tpu_torch.core import constants as C
    from ti_raytrace_tpu_torch.utils import vec

    pid = prim.clamp(min=0).long()
    v0, e1, e2 = scene.tri_v0[pid], scene.tri_e1[pid], scene.tri_e2[pid]
    p = vec.cross(d, e2)
    det = vec.dot(e1, p)
    tvec = torch.where(det[:, None] > 0.0, o - v0, v0 - o)
    inv = 1.0 / torch.clamp(det.abs(), min=1e-30)
    u = vec.dot(tvec, p) * inv
    v = vec.dot(d, vec.cross(tvec, e1)) * inv
    tri = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    sid = scene.prim_vidx[pid].clamp(0, scene.shape_pos.shape[0] - 1).long()
    oc = scene.shape_pos[sid] - o
    r2 = scene.shape_param[sid, 0] ** 2
    dop = vec.dot(d, oc) / torch.clamp(vec.dot(d, d), min=1e-30).sqrt()
    sph = (r2 - (vec.dot(oc, oc) - dop * dop)) / torch.clamp(r2, min=1e-30)
    return torch.where(scene.prim_type[pid] == C.PRIM_TRI, tri, sph)


def _oracle_check(scene, o, d, t_k, p_k, t_o, p_o, tmax=None, off_ties=False):
    """The kernel's (t_k, p_k) against the oracle's (t_o, p_o) on the same
    (N, 3) rays.  Bar: where both hit, |dt| <= T_RTOL * max(t, |o|_inf) —
    a ray leaving a surface and hitting its neighbour at t ~ 1e-4 rounds
    t against its origin's magnitude, not against t (beyond it: counted,
    at most PRIM_TIE_FRAC of hits, each within 1e-3: grazing hits, which
    the two formulations round apart); each differing prim id a t-tie
    (both prims re-intersected by the oracle at one distance, rtol 1e-3,
    or the kernel's prim hit at its edge, where the oracle's arithmetic
    misses it by a rounding and hits the neighbour), at most
    ORACLE_TIE_FRAC of hits; a hit on one
    side and a miss on the other only at an edge (|_edge_margin| <=
    EDGE_MARGIN),
    at most 1e-4 of the lanes.  With tmax (bounded where > 0) the oracle's
    hit beyond the bound counts as a miss, and a hit within rtol T_RTOL of
    its bound is counted instead (at most PRIM_TIE_FRAC of the lanes).
    off_ties: the share of differing prim ids counts only those that are
    not t-ties (the dense tracer's lowest-index tie rule differs from the
    oracle's by design, and sphere.obj's copies of each triangle make most
    of single_model's hits ties, which the two arithmetics round apart);
    each differing id must still be a t-tie or an edge.  Returns a dict of the
    figures and `ok`."""
    import torch

    from ti_raytrace_tpu_torch.scene.intersect import intersect_prim_any

    hit_o = p_o >= 0
    at_bound = torch.zeros_like(hit_o)
    if tmax is not None:
        bounded = tmax > 0
        at_bound = hit_o & bounded & ((t_o - tmax).abs() <= T_RTOL * tmax)
        hit_o = hit_o & ~(bounded & (t_o >= tmax))
    lanes = ~at_bound
    hit_k = p_k >= 0
    both = hit_o & hit_k & lanes
    n_hit = int(both.sum())

    dt = (t_k - t_o).abs()
    rel = torch.where(both, dt / torch.clamp(t_o.abs(), min=1e-30), 0.0)
    # a ray leaving a surface rounds its t against its origin's magnitude
    scaled = torch.where(both, dt / torch.maximum(t_o.abs(), o.abs().amax(dim=1)), 0.0)
    t_off = int((scaled > T_RTOL).sum())
    t_ok = t_off <= PRIM_TIE_FRAC * max(n_hit, 1) and float(scaled.max()) <= 1e-3

    mism = torch.nonzero(both & (p_k != p_o)).squeeze(1)
    ties_ok = True
    n_counted = mism.numel()
    if mism.numel():
        a = intersect_prim_any(scene, o[mism], d[mism], p_k[mism])
        b = intersect_prim_any(scene, o[mism], d[mism], p_o[mism])
        edge = _edge_margin(scene, o[mism], d[mism], p_k[mism]).abs() <= EDGE_MARGIN
        tie = (a - b).abs() <= 1e-3 * b.abs()
        ties_ok = bool((tie | edge).all())
        if off_ties:
            n_counted = int((~tie).sum())
    frac = n_counted / max(n_hit, 1)

    flip = torch.nonzero(lanes & (hit_o != hit_k)).squeeze(1)
    edges_ok = True
    if flip.numel():
        prim = torch.where(hit_k[flip], p_k[flip], p_o[flip])
        edges_ok = bool((_edge_margin(scene, o[flip], d[flip], prim).abs() <= EDGE_MARGIN).all())
    ok = (n_hit > 0 and t_ok and ties_ok and frac <= ORACLE_TIE_FRAC and edges_ok
          and flip.numel() <= 1e-4 * o.shape[0]
          and int(at_bound.sum()) <= PRIM_TIE_FRAC * o.shape[0])
    return dict(lanes=o.shape[0], hits=n_hit, ties=mism.numel() - n_counted,
                miss_flips=flip.numel(), edges_ok=edges_ok,
                max_rel_dt=float(rel.max()), t_beyond_rtol=int((rel > T_RTOL).sum()),
                max_scaled_dt=float(scaled.max()), t_beyond_scaled=t_off, t_ok=t_ok,
                prim_mismatch_frac=frac, ties_ok=ties_ok, at_bound=int(at_bound.sum()), ok=ok)


def _oracle_line(tag, name, what, r):
    log(f"{tag} {name}, {what}: {r['lanes']} lanes, {r['hits']} hits; hit/miss flips "
        f"{r['miss_flips']} (all at an edge={r['edges_ok']}); max |dt|/t {r['max_rel_dt']:.3e} "
        f"({r['t_beyond_rtol']} hits beyond {T_RTOL}), max |dt|/max(t, |o|) "
        f"{r['max_scaled_dt']:.3e} ({r['t_beyond_scaled']} beyond; ok={r['t_ok']}); prim mismatch "
        f"{r['prim_mismatch_frac']:.2e} of hits (ties ok={r['ties_ok']}; {r['ties']} t-ties "
        f"not counted); {r['at_bound']} lanes at their bound")
    if not r["ok"]:
        fail(f"{what} disagree on the {name} wavefront")


def phase_oracle(waves, sync):
    """Phase 22 on [(name, scene, kernel operands, tracer options)].
    Returns one row per wavefront."""
    import torch

    from ti_raytrace_tpu_torch import accel
    from ti_raytrace_tpu_torch.accel.traverse import trace_brute_force, trace_closest
    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import time_ms

    tag = "[22 oracle]"
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for name, scene, inputs, opts in waves:
        n = inputs[2]
        o_pl, d_pl = inputs[0][:, :n], inputs[1][:, :n]
        tmax = None if inputs[7] is None else inputs[7][:n]
        o, d = o_pl.T.contiguous(), d_pl.T.contiguous()
        ms_kernel, _ = time_ms(lambda: KERNEL(*inputs), KERNEL_REPS)
        if tmax is None:
            t_k, p_k = accel.trace_shaded(scene, o_pl, d_pl, sort_rays=False, **opts)[:2]
        else:
            t_k, p_k = accel.trace(scene, o_pl, d_pl, sort_rays=False, tmax=tmax, **opts)

        stats = {}
        sync()
        t0 = time.perf_counter()
        t_o, p_o = trace_closest(scene, o, d, stats=stats)
        sync()
        ms_oracle = (time.perf_counter() - t0) * 1e3
        r = _oracle_check(scene, o, d, t_k, p_k, t_o, p_o, tmax)
        log(f"{tag} {name}: {n} lanes: oracle {ms_oracle:.1f} ms, {stats['iterations']} "
            f"iterations; the kernel {ms_kernel:.4f} ms")
        _oracle_line(tag, name, "kernel vs BVH oracle", r)

        b = torch.linspace(0, n - 1, min(BRUTE_LANES, n), device=o.device).long()
        t_b, p_b = trace_brute_force(scene, o[b], d[b])
        tb = None if tmax is None else tmax[b]
        t_ob, p_ob = trace_closest(scene, o[b], d[b])
        _oracle_line(tag, name, "brute force vs BVH oracle",
                     _oracle_check(scene, o[b], d[b], t_ob, p_ob, t_b, p_b))
        _oracle_line(tag, name, "kernel vs brute force",
                     _oracle_check(scene, o[b], d[b], t_k[b], p_k[b], t_b, p_b, tb))
        rows.append(dict(wavefront=name, lanes=n, oracle_ms=ms_oracle,
                         oracle_iterations=stats["iterations"], kernel_ms=ms_kernel,
                         **{f"oracle_{key}": v for key, v in r.items()}))
        del t_k, p_k, t_o, p_o, o, d
    log(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    torch.cuda.empty_cache()
    return rows


def phase_dense_oracle(waves, sync):
    """Phase 22 for the dense kernel on [(path, name, scene, o, d, tmax)]:
    each wavefront traced by `dense_trace.trace_planar` (the kernel) and by
    the BVH oracle over the scene's own tree, held to `_oracle_check`'s
    bar off ties; a shadow batch's kernel hits at or beyond its bound read
    as misses, as its caller reads them.  Returns one row per wavefront."""
    import torch

    from ti_raytrace_tpu_torch.accel.traverse import trace_closest
    from ti_raytrace_tpu_torch.ops import dense_trace as dt

    tag = "[22 oracle]"
    rows = []
    for path, name, scene, o_pl, d_pl, tmax in waves:
        n = o_pl.shape[1]
        t_k, p_k = dt.trace_planar(scene, o_pl, d_pl)
        if tmax is not None:
            p_k = torch.where((tmax > 0) & (t_k >= tmax), -1, p_k)
        o, d = o_pl.T.contiguous(), d_pl.T.contiguous()
        stats = {}
        sync()
        t0 = time.perf_counter()
        t_o, p_o = trace_closest(scene, o, d, stats=stats)
        sync()
        ms_oracle = (time.perf_counter() - t0) * 1e3
        r = _oracle_check(scene, o, d, t_k, p_k, t_o, p_o, tmax, off_ties=True)
        log(f"{tag} {path} {name}: {n} lanes: oracle {ms_oracle:.1f} ms, "
            f"{stats['iterations']} iterations")
        _oracle_line(tag, f"{path} {name}", "dense kernel vs BVH oracle", r)
        rows.append(dict(path=path, wavefront=name, lanes=n, oracle_ms=ms_oracle,
                         oracle_iterations=stats["iterations"],
                         **{f"oracle_{key}": v for key, v in r.items()}))
        del t_k, p_k, t_o, p_o, o, d
    torch.cuda.empty_cache()
    return rows


def phase_native(host, root):
    """Phase 23."""
    import contextlib
    import io

    import numpy as np
    import torch

    from ti_raytrace_tpu_torch.examples import run
    from ti_raytrace_tpu_torch.io import native, obj
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.scene.build import prim_bounds
    from ti_raytrace_tpu_torch.utils.morton import morton3d

    tag = "[23 native]"
    scratch = os.path.join(native.BUILD_DIR, f"chip_smoke-{os.getpid()}.so")
    t0 = time.perf_counter()
    built = native.build(scratch)  # a fresh g++ build from the checkout's source
    seconds = time.perf_counter() - t0
    if built:
        os.remove(scratch)
    lib = native.get_lib()
    log(f"{tag} g++ build of {native.SOURCE}: {seconds:.2f} s, ok={built}; loaded "
        f"{native.library_path() if lib is not None else None}")
    if not built or lib is None:
        fail("native/tiray_native.cpp did not build or load")
    for model in ("Teapot.obj", "bdpt.obj", "cornell_box.obj"):
        path = asset_path(f"model/{model}")
        t0 = time.perf_counter()
        a = native.load_obj_native(path)
        ms_native = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        b = obj._load_obj_py(path)
        ms_py = (time.perf_counter() - t0) * 1e3
        same = (a is not None and [m.name for m in a.materials] == [m.name for m in b.materials]
                and all(np.allclose(getattr(x, f), getattr(y, f), rtol=1e-6)
                        for x, y in zip(a.materials, b.materials)
                        for f in ("diffuse", "emissive", "shininess", "optical_density",
                                  "transparency"))
                and all(p.tobytes() == q.tobytes() for p, q in zip(
                    a.tri_pos + a.tri_normal + a.tri_uv, b.tri_pos + b.tri_normal + b.tri_uv)))
        log(f"{tag} {model}: {a.triangle_count() if a else 0} triangles, native {ms_native:.1f} "
            f"ms, Python {ms_py:.1f} ms; equal={same}")
        if not same:
            fail(f"the native OBJ parse of {model} differs from the Python parser")
    pmin, pmax = prim_bounds(host)
    cent = 0.5 * (pmin + pmax)
    lo, hi = host["aabb_min"], host["aabb_max"]
    got = native.morton3d_native(cent, lo, hi)
    q = torch.from_numpy((cent - lo) / np.maximum(hi - lo, np.float32(1e-12)))
    want = morton3d(q[:, 0], q[:, 1], q[:, 2]).numpy()
    off = int((got != want).sum())
    log(f"{tag} morton3d_native vs morton3d on {cent.shape[0]} centroids: {off} codes differ "
        f"({off / cent.shape[0]:.2e})")
    if off > 1e-3 * cent.shape[0]:
        fail("morton3d_native disagrees with utils/morton.morton3d")

    out = io.StringIO()
    png = os.path.join(root, ".cache", "chip_smoke_cli.png")
    with contextlib.redirect_stdout(out):
        run.main(["benchmark_100k", "--size", str(SMALL), "--frames", "32",
                  "--snapshot-every", "16", "--device", "cuda", "--out", png])
    rep = json.loads(out.getvalue().strip().splitlines()[-1])
    meter = {k: rep.get(k) for k in ("fps", "spp_per_s", "avg_frame_ms", "compile_s")}
    log(f"{tag} CLI benchmark_100k {SMALL}^2, 32 frames in 2 merged dispatches: meter {meter}; "
        f"ms/frame {rep['ms_per_frame']:.3f}, overflow kills {rep['overflow_kills']}")
    if None in meter.values() or not meter["fps"] > 0.0 or rep["frames"] != 32:
        fail("the CLI's JSON line lacks the render meter's report")


def phase_sharded(sync):
    """Phase 24: the five sharded paths on 2 ranks (gloo) held to their
    per-shard mirror, Veach against the sliced production frame, the
    kernel on a rank's camera slice, and the merged path on 1 rank over
    NCCL.  Returns (kernel launches of the ranks, max |dt| of the kernel on
    the rank's slice, the "sharded" rows, dense kernel launches of the
    ranks)."""
    import numpy as np
    import torch

    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.examples.scenes import example_cached, make_camera
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb
    from ti_raytrace_tpu_torch.parallel import dryrun, shard
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import recording

    tag = "[24 sharded]"
    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(SHARD_RANKS, device="cuda", size=SIZE, frames=KF,
                                  timeout=SHARD_TIMEOUT)
    log(f"{tag} {SHARD_RANKS} ranks on one card: all five sections bit-equal to the "
        f"per-shard mirror in {time.perf_counter() - t0:.1f} s; ranks joined after "
        + ", ".join(f"{s:.2f}" for s in res["start_s"]) + " s; one all_reduce of a (3, "
        f"{SIZE}^2) float32 image " + ", ".join(f"{t:.3f}" for t in res["all_reduce_ms"])
        + " ms per rank")
    for section in dryrun.SECTIONS:
        r = res[section]
        log(f"{tag} {section} ({r['backend']}): {r['frames']} frame(s) at {SIZE}^2, "
            f"{max(r['seconds']) / r['frames'] * 1e3:.3f} ms/frame on the {SHARD_RANKS} ranks "
            f"together, {r['mirror_seconds'] / r['frames'] * 1e3:.3f} ms/frame shard after "
            f"shard in one process; overflow {r['overflow']}; kernel launches per rank "
            f"{r['launches']}, dense kernel {r['dense_launches']}, rng kernel "
            f"{r['rng_launches']}; image mean {float(r['img'].mean()):.5f}")
        if r["backend"] != "gloo":
            fail(f"{SHARD_RANKS} ranks on one card ran {r['backend']}, not gloo")
        for rank, widths in enumerate(r["rng_launches_per_width"]):
            _rng_counts(f"{tag} {section} rank {rank}:", f"sharded {section}", r["frames"],
                        {"rng": widths})
    merged = res["merged"]
    if merged["overflow"] != 0:
        fail(f"{merged['overflow']} overflow kills on the sharded merged path")
    if min(merged["launches"]) == 0:
        fail(f"a rank of the sharded merged path launched no kernel: {merged['launches']}")
    if min(res["bdpt"]["launches"]) == 0:
        fail("a rank of the sharded Veach BDPT launched no kernel")
    for section in DENSE_SECTIONS:
        if min(res[section]["dense_launches"]) == 0 or max(res[section]["launches"]) != 0:
            fail(f"a rank of the sharded {section} section (a dense scene) launched no dense "
                 f"kernel or the cluster kernel: {res[section]['dense_launches']}, "
                 f"{res[section]['launches']}")

    scene, cfg = example_cached("veach_bdpt", "cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    t0 = time.perf_counter()
    want, ov = bdpt_rgb.render_frame_sliced(scene, spec, cam, 1, rng.PRNGKey(dryrun.SEED),
                                            n_slices=SHARD_RANKS, return_overflow=True)
    sync()
    ms_sliced = (time.perf_counter() - t0) * 1e3
    want = want.cpu().numpy()
    got = res["bdpt"]["img"]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    off = int((~np.isclose(got, want, rtol=1e-5, atol=0.0)).any(axis=-1).sum())
    log(f"{tag} Veach BDPT, {SHARD_RANKS} ranks vs render_frame_sliced({SHARD_RANKS}) "
        f"({ms_sliced:.3f} ms): {int((got != want).any(axis=-1).sum())} pixels differ, "
        f"{off} beyond rtol 1e-5, max rel diff {float(rel.max()):.3e}; overflow "
        f"{res['bdpt']['overflow']} vs {int(ov)}")
    if off > SHARD_PIXEL_FRAC * SIZE * SIZE or res["bdpt"]["overflow"] != int(ov):
        fail("the sharded Veach BDPT frame disagrees with the sliced production frame")
    del scene

    # the kernel on rank 0's camera slice: the shared-origin mode on the
    # rank's interleaved 256-lane morton blocks of the film
    scene, cfg = example_cached("benchmark_100k", "cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    mesh = shard.Mesh(0, SHARD_RANKS, scene.device)
    px, py = shard.shard_pixels(spec, mesh)
    n = px.shape[0]
    with recording() as calls:
        shard._merged_lane_shard(scene, spec, cam, torch.zeros((3, n), device=scene.device),
                                 0, rng.PRNGKey(dryrun.SEED), 0, px, py, 1, 1,
                                 cfg.compaction, False, max_depth=1)
    if not calls or calls[0][2] != n or not calls[0][6]:
        fail("the rank's camera slice did not reach the kernel in the shared-origin mode")
    err, row = _compare(f"rank 0 camera slice of {SHARD_RANKS} (shared origin, origin-MT)",
                        calls[0], tag)
    row["launches_per_frame"] = sum(w.get(n, 0) for w in merged["launches_per_width"]) / KF
    del scene, calls
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    one = dryrun.dryrun_multichip(1, device="cuda", size=SIZE, frames=KF, sections=("merged",),
                                  timeout=SHARD_TIMEOUT)
    r = one["merged"]
    log(f"{tag} merged on 1 rank ({r['backend']}): {max(r['seconds']) / KF * 1e3:.3f} "
        f"ms/frame, overflow {r['overflow']}, kernel launches {r['launches']}, equal to its "
        f"mirror; joined after {one['start_s'][0]:.2f} s, one all_reduce of the image "
        f"{one['all_reduce_ms'][0]:.3f} ms, {time.perf_counter() - t0:.1f} s in all")
    if r["backend"] != "nccl" or r["overflow"] != 0 or r["launches"][0] == 0:
        fail("the 1-rank NCCL run of the merged path did not pass")
    launches = sum(sum(res[s]["launches"]) for s in dryrun.SECTIONS) + r["launches"][0]
    dense = sum(sum(res[s]["dense_launches"]) for s in dryrun.SECTIONS)
    return launches, err, [row], dense


def phase_dense_kernel(rows, camera_waves, sm_mhz):
    """Phase 25: the dense kernel against the plain sweep on the six
    wavefronts of the dense paths.  Phases 13 and 19 held it on
    single_model's camera and merged bounce-1 wavefronts and on prism's
    fused walk and packed shadow batch (`rows`); here cornell_box's and
    sky_dome's 512^2 camera wavefronts, recorded in phases 14 and 15, go
    through the same comparison, then every row is printed with its path's
    launches per frame at its width, the kernel's time, the plain
    sweep's, the (warp, group) pairs tested and the share culled, the
    bound of the work done and the two brute-force bounds with the
    kernel's share of each, and the cluster tracer's time on the same
    rays.  Any differing bit of t or prim fails.  Returns the six rows."""
    tag = "[25 dense kernel]"
    rows = list(rows)
    for path, (scene, o, d), per_frame in camera_waves:
        origin = o[:, 0].contiguous() if bool((o == o[:, :1]).all()) else None
        r, = _dense_rows(tag, scene, [("camera", o, d, origin)], DENSE_REPS, per_frame,
                         sm_mhz)
        r["path"] = path
        rows.append(r)
    for r in rows:
        log(f"{tag} {r['path']} {r['wavefront']}: {r['lanes']} lanes x {r['prims']} prims, "
            f"{r['launches_per_frame']:g} launches per frame; kernel {r['kernel_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.3f} ms; "
            f"{r['tested']} of {r['pairs']} (warp, group) pairs tested ({r['tested_rows']} "
            f"rows), culled {r['culled_frac']:.4f}, {r['guarded']} guarded ({r['looped']} "
            f"looped, {r['looped_rows']} rows); bound of "
            f"the work done {r['bound_ms']:.4f} ms (share {r['share']:.4f}; instructions by "
            f"pipe {r['work_instructions']}); the brute-force work it no longer does: "
            f"{r['brute_peak_ms']:.4f} ms at the FP32 peak (share {r['brute_peak_share']:.4f}), "
            f"{r['brute_issue_ms']:.4f} ms at its SASS count (share "
            f"{r['brute_issue_share']:.4f}); cluster tracer "
            f"{r['cluster_ms']:.3f} ms (its kernel {r['cluster_kernel_ms']:.4f} ms); "
            f"bit-equal={r['bit_equal']}")
    if len(rows) != 6 or not all(r["bit_equal"] for r in rows):
        fail("the dense kernel was not held bit for bit against the plain sweep on the six "
             "wavefronts")
    return rows


def _rng_bound(n, sm_mhz):
    """The least time of an n-element draw: its UNIFORM_INT_OPS integer
    operations per element, of which UNIFORM_ALU_OPS only the ALU pipe
    runs, at max(ALU ops / ALU_PER_CLOCK, all ops / ISSUE_PER_CLOCK) clocks
    per element and SM lane on SM_COUNT SMs at the maximum SM clock,
    against 4 bytes written per element at the card's memory rate.
    Returns (ms, what bounds it, ops, bytes)."""
    from ti_raytrace_tpu_torch.core.rng import UNIFORM_ALU_OPS, UNIFORM_INT_OPS
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import (ISSUE_PER_CLOCK, PEAK_BYTES,
                                                             SM_COUNT)

    ops, nbytes = UNIFORM_INT_OPS * n, 4 * n
    clocks = max(UNIFORM_ALU_OPS / ALU_PER_CLOCK, UNIFORM_INT_OPS / ISSUE_PER_CLOCK)
    t_ops = n * clocks / (SM_COUNT * sm_mhz * 1e6)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", ops, nbytes


def phase_rng(sm_mhz):
    """Phase 26: the threefry kernel against `uniform_plain` bit for bit on
    RNG_SHAPES and on every other element count that RNG_RUNS recorded;
    RNG_SHAPES timed.  Returns (the rows of RNG_SHAPES, the largest |kernel
    - plain| over every compared draw)."""
    import math

    import torch

    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import time_ms

    tag = "[26 rng kernel]"
    dev = torch.device("cuda")
    key = rng.fold_in(rng.split(rng.PRNGKey(12))[1], 3)
    k1, k2 = key.tolist()
    listed = {math.prod(s) for s in RNG_SHAPES}
    recorded = sorted({w for _, _, per_frame in RNG_RUNS for w in per_frame} - listed)
    rows, max_err = [], 0.0
    for shape in RNG_SHAPES + tuple((w,) for w in recorded):
        n = math.prod(shape)
        got = rng.uniform(key, shape, dev)
        want = rng.uniform_plain(key, shape, dev)
        equal = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not equal:
            fail(f"the threefry kernel differs from uniform_plain on a {shape} draw")
        if shape not in RNG_SHAPES:
            continue
        out = torch.empty(n, dtype=torch.float32, device=dev)
        ms, _ = time_ms(lambda: rng.UNIFORM_KERNEL.launch(
            "threefry_uniform_launch", out.device, out.data_ptr(), k1, k2, n), RNG_REPS)
        if not torch.equal(out.view(shape), got):
            fail(f"the raw threefry launch on {shape} differs")
        ms_call, _ = time_ms(lambda: rng.uniform(key, shape, dev), RNG_REPS)
        ms_plain, _ = time_ms(lambda: rng.uniform_plain(key, shape, dev), 3)
        ms_rand, _ = time_ms(lambda: torch.rand(shape, device=dev), RNG_REPS)
        bound_ms, bound_by, ops, nbytes = _rng_bound(n, sm_mhz)
        row = dict(shape=list(shape), elements=n, ms=ms, call_ms=ms_call, plain_ms=ms_plain,
                   bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes,
                   share=bound_ms / ms, max_abs_err=err, bit_equal=equal,
                   torch_rand_ms=ms_rand)
        log(f"{tag} context: torch.rand{shape} (Philox, another function) {ms_rand:.4f} ms")
        log(f"{tag} {shape}: bit-equal={equal}; kernel {ms:.4f} ms ({RNG_REPS} raw launches), "
            f"{ms_call:.4f} ms per rng.uniform call, plain {ms_plain:.3f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({ops} ops, {nbytes} B); share {row['share']:.4f}")
        rows.append(row)
    log(f"{tag} bit-equal on {len(RNG_SHAPES)} listed shapes and {len(recorded)} other recorded "
        f"element counts; max |kernel - plain| {max_err:g}")
    return rows, max_err


def phase_disney():
    """Phase 27: the Disney kernels against their plain twins bit for bit
    on random lanes at DISNEY_WIDTHS, timed; then each path's launches per
    frame from DISNEY_RUNS.  Returns the rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ti_raytrace_tpu_torch.bsdf import planar
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import PEAK_BYTES, time_ms

    tag = "[27 disney kernel]"
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    k = planar.DISNEY_KERNEL

    def unit(n):
        v = torch.randn(3, n, device=dev, generator=g)
        return v / v.norm(dim=0, keepdim=True)

    def bits_equal(a, b):
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
        return bool(same.all())

    rows = []
    for n in DISNEY_WIDTHS:
        ev = (unit(n), unit(n), unit(n), torch.rand(n, device=dev, generator=g),
              torch.rand(n, device=dev, generator=g))
        sa = (torch.rand(3, n, device=dev, generator=g), unit(n), unit(n),
              torch.rand(n, device=dev, generator=g), torch.rand(n, device=dev, generator=g))
        cases = (
            ("eval", lambda: k.evaluate_pdf(*ev), lambda: planar.disney_evaluate_pdf_plain(*ev),
             "disney_evaluate_pdf_kernel"),
            ("eval_true_pdf", lambda: k.evaluate_pdf(*ev, True),
             lambda: planar.disney_evaluate_pdf_plain(*ev, true_pdf=True),
             "disney_evaluate_pdf_kernel"),
            ("sample", lambda: k.sample(*sa), lambda: planar.disney_sample_plain(*sa),
             "disney_sample_kernel"))
        for op, kernel, plain, name in cases:
            got, want = kernel(), plain()
            got, want = (got, want) if op == "sample" else (torch.stack(got), torch.stack(want))
            equal = bits_equal(got, want)
            if not equal:
                fail(f"the Disney {op} kernel differs from its plain twin at {n} lanes")
            call_ms, _ = time_ms(kernel, DISNEY_REPS)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(DISNEY_REPS):
                    kernel()
                torch.cuda.synchronize()
            evts = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and name in e.key]
            launches = sum(e.count for e in evts)
            kernel_us = (sum(e.self_device_time_total for e in evts) / launches
                         if launches else float("nan"))
            plain_ms, _ = time_ms(plain, 3)
            read, written = DISNEY_BYTES[op]
            bound_us = n * (read + written) / PEAK_BYTES * 1e6
            row = dict(op=op, lanes=n, bit_equal=equal, kernel_us=kernel_us,
                       call_us=call_ms * 1e3, plain_ms=plain_ms, bound_us=bound_us,
                       bound_by="bytes", bytes=n * (read + written),
                       share=bound_us / kernel_us if launches else None,
                       profiled_launches=launches)
            log(f"{tag} {op} at {n} lanes: bit-equal={equal}; kernel {kernel_us:.3f} us a "
                f"launch ({launches} profiled), {row['call_us']:.3f} us a wrapper call "
                f"(events over {DISNEY_REPS}), plain {plain_ms:.3f} ms; bound {bound_us:.3f} us "
                f"by bytes ({read}+{written} B a lane); share {row['share']}")
            rows.append(row)
    for path, frames, launches in DISNEY_RUNS:
        log(f"{tag} {path}: " + ", ".join(f"{op} {c / frames:g}" for op, c in
                                          sorted(launches.items())) + " launches a frame")
    return rows


def _shade_lanes(n, gen):
    """Random lanes of one shading call on the card: (carry, u, t, prim,
    uv_bary, attr, light sample, shadow prims): glass, Disney and emitter
    hits of triangles and spheres, misses, dead lanes."""
    import torch

    from ti_raytrace_tpu_torch.scene.packs import PRIM_A

    dev = torch.device("cuda")

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    def unit(k):
        v = torch.randn(3, k, device=dev, generator=gen)
        return v / v.norm(dim=0, keepdim=True)

    miss = rand(n) < 0.15
    t = torch.where(miss, 1.0e6, rand(n) * 8.0 + 0.01)
    prim = torch.where(miss, -1, torch.randint(0, 1000, (n,), device=dev, generator=gen))
    prim = prim.to(torch.int32)
    attr = torch.zeros(PRIM_A, n, device=dev)
    g = unit(n)
    attr[0:3] = g
    for r in (3, 6, 9):
        attr[r:r + 3] = g + 0.3 * unit(n)
    attr[18] = torch.randint(0, 3, (n,), device=dev, generator=gen).float()
    attr[19:22] = rand(3, n)
    attr[22] = torch.where(attr[18] == 1, 1.05 + rand(n), rand(n))
    attr[23] = rand(n) * 4.0
    attr[24] = rand(n)
    attr[25] = (rand(n) < 0.3).float()
    attr[26:29] = torch.randn(3, n, device=dev, generator=gen)
    attr[:, miss] = 0.0
    carry = dict(origin=torch.randn(3, n, device=dev, generator=gen), direction=unit(n),
                 throughput=rand(3, n), radiance=rand(3, n) * 0.1, alive=rand(n) < 0.8,
                 brdf_pdf=rand(n) * 2.0, perfect_spec=rand(n) < 0.4, miss_dir=unit(n),
                 miss_weight=rand(3, n), pixel=torch.arange(n, device=dev))
    ls = dict(pos=torch.randn(3, n, device=dev, generator=gen), normal=unit(n),
              direction=unit(n), emission=rand(3, n) * 20.0, dist=rand(n) * 5.0 + 0.05,
              choice_pdf=rand(n) + 0.01)
    sh_prim = torch.where(rand(n) < 0.7, prim, prim + 1)
    return (carry, rand(8, n), t, prim, rand(2, n) * 0.5, attr, ls, sh_prim)


def phase_shade():
    """Phase 28: the PT shading kernel (both routes of pt_rgb._shade)
    against its plain twin bit for bit on random lanes at SHADE_WIDTHS,
    without NEE (one launch) and with it (head and tail, the light sample
    and shadow prims given), timed; the wrapper's host cost a call; then
    each PT path's launches a frame from SHADE_RUNS.  Returns the rows."""
    from types import SimpleNamespace

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ti_raytrace_tpu_torch.integrators import pt_rgb
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import PEAK_BYTES, time_ms

    tag = "[28 pt shade kernel]"
    gen = torch.Generator(device="cuda").manual_seed(28)
    k = pt_rgb.SHADE_KERNEL
    scene = SimpleNamespace(n_lights=3)
    carry_keys = ("origin", "direction", "throughput", "radiance", "alive", "brdf_pdf",
                  "perfect_spec", "miss_dir", "miss_weight", "pixel")

    def bits_equal(a, b):
        if a.dtype != torch.float32:
            return torch.equal(a, b)
        return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())

    def plain(lanes, nee):
        carry, u, t, prim, uv, attr, ls, sh_prim = lanes
        saved = pt_rgb.sample_li, pt_rgb.trace
        pt_rgb.sample_li = lambda sc, pos, u3: ls
        pt_rgb.trace = lambda sc, o, d, sort_small=False: (None, sh_prim)
        try:
            return pt_rgb._shade_plain(scene, carry, u, t, prim, uv, attr, nee)
        finally:
            pt_rgb.sample_li, pt_rgb.trace = saved

    def kernel_us(fn, name="pt_shade_kernel"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SHADE_REPS):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        launches = sum(e.count for e in evts)
        return (sum(e.self_device_time_total for e in evts) / launches
                if launches else float("nan")), launches

    rows = []
    for n in SHADE_WIDTHS:
        lanes = _shade_lanes(n, gen)
        carry, u, t, prim, uv, attr, ls, sh_prim = lanes
        head = lambda: k.head(carry, t, prim, attr)  # noqa: E731
        cases = (
            ("full", lambda: k.shade(carry, u, t, prim, uv, attr), False),
            ("head", head, True),
            ("tail", lambda: k.shade(carry, u, t, prim, uv, attr, nee=(ls, sh_prim, 3)), True))
        for op, fn, nee in cases:
            if op == "head":
                pos, is_disney = fn()
                hit_pos = carry["origin"] + carry["direction"] * t[None]
                equal = bits_equal(pos, hit_pos)
            else:
                got, want = fn(), plain(lanes, nee)
                equal = all(bits_equal(got[key], want[key]) for key in carry_keys)
            if not equal:
                fail(f"the pt shade kernel's {op} entry differs from its plain twin at {n} lanes")
            us, launches = kernel_us(fn)
            call_ms, _ = time_ms(fn, SHADE_REPS)
            plain_ms = time_ms(lambda: plain(lanes, nee), 3)[0] if op != "head" else None
            read, written = SHADE_BYTES[op]
            bound_us = n * (read + written) / PEAK_BYTES * 1e6
            row = dict(op=op, lanes=n, bit_equal=equal, kernel_us=us, call_us=call_ms * 1e3,
                       plain_ms=plain_ms, bound_us=bound_us, bound_by="bytes",
                       bytes=n * (read + written), share=bound_us / us if launches else None,
                       profiled_launches=launches)
            log(f"{tag} {op} at {n} lanes: bit-equal={equal}; kernel {us:.3f} us a launch "
                f"({launches} profiled), {row['call_us']:.3f} us a wrapper call (events over "
                f"{SHADE_REPS}), plain {plain_ms} ms; bound {bound_us:.3f} us by bytes "
                f"({read}+{written} B a lane); share {row['share']}")
            rows.append(row)
        del lanes, carry, u, t, prim, uv, attr, ls, sh_prim
    lanes = _shade_lanes(SHADE_HOST_LANES, gen)
    carry, u, t, prim, uv, attr, ls, sh_prim = lanes
    for op, fn in (("full", lambda: pt_rgb._shade(scene, carry, u, t, prim, uv, attr)),
                   ("head+tail", lambda: (k.head(carry, t, prim, attr),
                                          k.shade(carry, u, t, prim, uv, attr,
                                                  nee=(ls, sh_prim, 3))))):
        fn()
        torch.cuda.synchronize()
        reps = 2000
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        log(f"{tag} host cost of {op} at {SHADE_HOST_LANES} lanes: {host_us:.2f} us a call "
            f"(host clock over {reps} calls, no sync between)")
        rows.append(dict(op=f"host {op}", lanes=SHADE_HOST_LANES, host_us=host_us))
    for path, frames, launches in SHADE_RUNS:
        log(f"{tag} {path}: " + ", ".join(f"{op} {c / frames:g}" for op, c in
                                          sorted(launches.items())) + " launches a frame")
    return rows


def _box(scene):
    """The scene's box alone (all that the coherence key reads of it)."""
    from types import SimpleNamespace

    return SimpleNamespace(aabb_min=scene.aabb_min.clone(), aabb_max=scene.aabb_max.clone())


def _key_lanes(n, gen, box):
    """n lanes of every kind about the scene box `box` (aabb_min, aabb_max):
    origins inside it, in a box three times as wide and parked at 1e9;
    unit, zero and negative-zero directions; NaN and +-inf coordinates on
    one lane in 64; with `active` and `alive` masks.  On the card."""
    import torch

    dev = box.aabb_min.device
    lo, hi = box.aabb_min[:, None], box.aabb_max[:, None]
    u = torch.rand(3, n, generator=gen, device=dev)
    kind = torch.randint(0, 8, (n,), generator=gen, device=dev)
    o = torch.where(kind == 1, lo + (u * 3 - 1) * (hi - lo), lo + u * (hi - lo))
    o = torch.where(kind == 2, torch.full_like(o, 1e9), o)
    d = torch.nn.functional.normalize(torch.randn(3, n, generator=gen, device=dev), dim=0)
    d = torch.where(kind == 3, torch.where(u < 0.5, 0.0, -0.0), d)
    special = torch.tensor([float("nan"), float("inf"), float("-inf")], device=dev)
    odd = torch.randint(0, 64, (2, 3, n), generator=gen, device=dev) == 0
    pick = torch.randint(0, 3, (2, 3, n), generator=gen, device=dev)
    o = torch.where(odd[0], special[pick[0]], o)
    d = torch.where(odd[1], special[pick[1]], d)
    active = torch.rand(n, generator=gen, device=dev) > 0.25
    alive = torch.rand(n, generator=gen, device=dev) > 0.3
    return o, d, active, alive


def phase_order(boxes):
    """Phase 29: the coherence key kernel (ops/cluster_trace.sort_key on the
    card) against its plain twin bit for bit, key and stable order, on lanes
    of every kind (`_key_lanes`) about each path's scene box at every width
    that ORDER_RUNS recorded, padded and with `active`, and with `alive`;
    at each path's widest: the kernel's us a launch (device time under
    torch.profiler over ORDER_REPS launches), `_coherence_order`'s us a call
    (CUDA events), the plain twin's, the bound (ORDER_BYTES a lane at 3.35
    TB/s) and the share; the host us a `_coherence_order` call at
    ORDER_HOST_LANES lanes on each route; each path's launches a frame.
    Returns the rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ti_raytrace_tpu_torch.ops import cluster_trace as ct
    from ti_raytrace_tpu_torch.tools.kernel_wavefronts import PEAK_BYTES, time_ms

    tag = "[29 coherence key kernel]"
    gen = torch.Generator(device="cuda").manual_seed(29)
    k = ct.COHERENCE_KERNEL

    def plain_order(box, o, d, n_pad, active):
        return torch.sort(ct._sort_key_plain(box, o, d, n_pad, active), stable=True).indices

    rows = []
    if not ORDER_RUNS:
        fail("no counted run launched the coherence key kernel")
    for path, frames, per_n in ORDER_RUNS:
        box = boxes[path]
        log(f"{tag} {path}: {sum(per_n.values()) / frames:g} launches a frame over "
            f"{len(per_n)} widths, {min(per_n)}-{max(per_n)} lanes")
        for n in sorted(per_n, reverse=True):
            o, d, active, alive = _key_lanes(n, gen, box)
            n_pad = -(-n // ct.TILE) * ct.TILE
            for args in ((n_pad, active, None), (None, None, alive)):
                got = ct.sort_key(box, o, d, *args)
                want = ct._sort_key_plain(box, o, d, *args)
                if not torch.equal(got, want):
                    fail(f"the coherence key kernel differs from its plain twin on {path}'s "
                         f"{n}-lane wavefront ({'padded, active' if args[0] else 'alive'})")
            if not torch.equal(ct._coherence_order(box, o, d, n_pad, active),
                               plain_order(box, o, d, n_pad, active)):
                fail(f"the coherence order differs from the plain twin's on {path}'s {n} lanes")
        n = max(per_n)
        o, d, active, alive = _key_lanes(n, gen, box)
        n_pad = -(-n // ct.TILE) * ct.TILE
        launch = lambda: k(o, d, box.aabb_min, box.aabb_max, n_pad, active)  # noqa: E731
        launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ORDER_REPS):
                launch()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "coherence_key_kernel" in e.key]
        profiled = sum(e.count for e in evts)
        us = (sum(e.self_device_time_total for e in evts) / profiled
              if profiled else float("nan"))
        call_ms, _ = time_ms(lambda: ct._coherence_order(box, o, d, n_pad, active), ORDER_REPS)
        plain_ms, _ = time_ms(lambda: plain_order(box, o, d, n_pad, active), 5)
        sort_ms, _ = time_ms(lambda: torch.sort(launch(), stable=True), ORDER_REPS)
        bound_us = n * ORDER_BYTES / PEAK_BYTES * 1e6
        row = dict(path=path, lanes=n, bit_equal=True, widths=len(per_n),
                   launches_per_frame=sum(per_n.values()) / frames, kernel_us=us,
                   profiled_launches=profiled, order_ms=call_ms, key_and_sort_ms=sort_ms,
                   plain_ms=plain_ms, bound_us=bound_us, bound_by="bytes",
                   bytes=n * ORDER_BYTES, share=bound_us / us if profiled else None)
        log(f"{tag} {path} at {n} lanes: bit-equal on {len(per_n)} widths; kernel {us:.3f} us "
            f"a launch ({profiled} profiled), bound {bound_us:.3f} us by bytes "
            f"({ORDER_BYTES} B a lane), share {row['share']}; _coherence_order {call_ms:.4f} "
            f"ms a call (key and torch.sort {sort_ms:.4f}), plain {plain_ms:.4f} ms")
        rows.append(row)
    box = boxes[ORDER_RUNS[0][0]]
    o, d, active, _ = _key_lanes(ORDER_HOST_LANES, gen, box)
    for route, fn in (("kernel", lambda: ct._coherence_order(box, o, d, ORDER_HOST_LANES, active)),
                      ("plain", lambda: plain_order(box, o, d, ORDER_HOST_LANES, active))):
        fn()
        torch.cuda.synchronize()
        reps = 2000
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        log(f"{tag} host cost of _coherence_order on the {route} route at {ORDER_HOST_LANES} "
            f"lanes: {host_us:.2f} us a call (host clock over {reps} calls, no sync between)")
        rows.append(dict(op=f"host {route}", lanes=ORDER_HOST_LANES, host_us=host_us))
    return rows


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

    sm_mhz = phase_device()
    phase_build()
    t0 = time.perf_counter()
    scene, cfg = benchmark_100k("cuda")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    log(f"[3 kernel] scene: {scene.n_prims} prims, {scene.cluster_bounds.shape[1]} "
        f"clusters, built in {time.perf_counter() - t0:.2f} s")
    boxes = {}  # phase 29: each cluster path's scene box
    boxes["bench"] = boxes["bench_preview"] = _box(scene)
    max_err, rows, (camera, deep) = phase_kernel(scene, spec, cam, cfg)
    launches, per_frame = phase_main_path(scene, spec, cam, cfg, sync)
    _attach_launches(rows, per_frame)
    phase_small_parity(cfg)
    cam_o = camera[1][0][:, :camera[1][2]]
    if not bool((cam_o == cam_o[:, :1]).all()):
        fail("the recorded camera wavefront's rays do not share one origin")
    oracle_waves = [  # (name, scene, kernel operands, tracer options) for phase 22
        ("bench camera (shared origin)", scene, camera[1],
         dict(shared_origin=camera[1][0][:, 0])),
        ("bench bounces 1-2 (per-tile order)", scene, deep[1], dict(tile_order=True))]

    t0 = time.perf_counter()
    vscene, vcfg = veach_bdpt("cuda")
    vspec, vcam = make_camera(vscene, vcfg, SIZE, SIZE)
    log(f"[6 veach kernel] scene: {vscene.n_prims} prims, {vscene.n_lights} lights, "
        f"{vscene.cluster_bounds.shape[1]} clusters, built in "
        f"{time.perf_counter() - t0:.2f} s")
    boxes["veach_pt"] = boxes["veach_bdpt"] = _box(vscene)
    err_v, veach_rows, bounce1 = phase_veach_kernel(vscene, vspec, vcam)
    oracle_waves.append(("veach_pt bounce 1 (sorted)", vscene, bounce1[1],
                         dict(tile_order=True)))
    max_err = max(max_err, err_v)
    n, per_frame = phase_veach_path(vscene, vspec, vcam, vcfg, sync)
    launches += n
    _attach_launches(veach_rows, per_frame)
    phase_veach_parity(vcfg)

    err_b, bdpt_rows, shadow = phase_bdpt_kernel(vscene, vspec, vcam)
    oracle_waves.append(("veach_bdpt shadow batch (sorted, tmax)", vscene, shadow[1],
                         dict(tile_order=True)))
    max_err = max(max_err, err_b)
    n, per_frame = phase_bdpt_path(vscene, vspec, vcam, vcfg, sync)
    launches += n
    _attach_launches(bdpt_rows, per_frame)
    phase_bdpt_parity(vcfg)
    del scene, vscene  # phase 22 holds what it needs
    torch.cuda.empty_cache()

    dense_launches, dense_rows, dense_oracle_waves = phase_single_model(sync, sm_mhz)
    camera_waves = []  # phase 25's: cornell_box's and sky_dome's camera wavefronts
    for tag, name, frames in (("[14 cornell_box]", "cornell_box", CORNELL_FRAMES),
                              ("[15 sky_dome]", "sky_dome", SPEC_FRAMES),
                              ("[16 spectral_box]", "spectral_box", SPEC_FRAMES)):
        n, per_frame, wave = phase_dense_path(tag, name, frames, sync)
        dense_launches += n
        if name != "spectral_box":
            camera_waves.append((name, wave, per_frame))
            dense_oracle_waves.append((name, "camera") + wave + (None,))
    for name in ("single_model", "cornell_box", "sky_dome", "spectral_box"):
        phase_dense_parity(name)
    err_p, prism_rows, n, prism_dense_rows, prism_waves = phase_prism(sync, sm_mhz)
    dense_launches += n
    dense_rows += prism_dense_rows
    dense_oracle_waves += prism_waves
    max_err = max(max_err, err_p)
    _attach_launches(prism_rows, {})  # the prism path takes the dense tracer: 0 launches
    phase_dense_parity("prism_rainbow", phase=20)
    host = phase_lbvh(sync)
    oracle_rows = phase_oracle(oracle_waves, sync)
    dense_oracle_rows = phase_dense_oracle(dense_oracle_waves, sync)
    del oracle_waves, dense_oracle_waves
    phase_native(host, root)
    n, err_s, shard_rows, n_dense = phase_sharded(sync)
    launches += n
    dense_launches += n_dense
    max_err = max(max_err, err_s)
    dense_rows = phase_dense_kernel(dense_rows, camera_waves, sm_mhz)
    del camera_waves
    rng_rows, rng_err = phase_rng(sm_mhz)
    rng_main = next(r for r in rng_rows if r["shape"] == [8, SIZE * SIZE])
    disney_rows = phase_disney()
    shade_rows = phase_shade()
    order_rows = phase_order(boxes)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    paths = (("bench", rows), ("veach_pt", veach_rows), ("veach_bdpt", bdpt_rows),
             ("prism_rainbow", prism_rows), ("sharded", shard_rows))
    print(json.dumps({"kernels": [{
        "name": "cluster_trace",
        "route": "cuda",
        "source": "ti_raytrace_tpu_torch/csrc/cluster_trace.cu",
        "replaces": "ti_raytrace_tpu/ops/cluster_trace.py:189",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": rows[0]["ms"],
        "plain_ms": rows[0]["plain_ms"],
        "bound_ms": rows[0]["bound_ms"],
        "bound_by": rows[0]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a closest hit over clusters
        "wavefronts": [dict(path=p, **r) for p, rs in paths for r in rs],
        "oracle": oracle_rows,
    }, {
        "name": "dense_sweep",
        "route": "cuda",
        "source": "ti_raytrace_tpu_torch/csrc/dense_trace.cu",
        "replaces": "ti_raytrace_tpu/ops/dense_trace.py:147",
        "launches": dense_launches,
        "max_abs_err": max(r["max_abs_err"] for r in dense_rows),
        "ms": dense_rows[0]["kernel_ms"],
        "plain_ms": dense_rows[0]["plain_ms"],
        "bound_ms": dense_rows[0]["bound_ms"],
        "bound_by": dense_rows[0]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a closest hit over triangles
        "wavefronts": dense_rows,
        "oracle": dense_oracle_rows,
    }, {
        "name": "threefry_uniform",
        "route": "cuda",
        "source": "ti_raytrace_tpu_torch/csrc/rng.cu",
        "replaces": "ti_raytrace_tpu/integrators/pt_rgb.py:186",  # jax.random.uniform, XLA
        "launches": sum(n for _, n, _ in RNG_RUNS),
        "max_abs_err": rng_err,
        "ms": rng_main["ms"],
        "plain_ms": rng_main["plain_ms"],
        "bound_ms": rng_main["bound_ms"],
        "bound_by": rng_main["bound_by"],
        "library_ms": None,  # torch.rand draws Philox: no PyTorch call computes threefry
        "shapes": rng_rows,
        "paths": [dict(path=p, launches=n, draws_per_frame=sum(w.values()),
                       draws_per_frame_by_elements=w) for p, n, w in RNG_RUNS],
    }, {
        "name": "disney",
        "route": "cuda",
        "source": "ti_raytrace_tpu_torch/csrc/disney.cu",
        "replaces": None,  # the JAX package's Disney BSDF is plain XLA
        "launches": sum(sum(c.values()) for _, _, c in DISNEY_RUNS),
        "library_ms": None,  # no PyTorch call computes the Disney BSDF
        "rows": disney_rows,
        "paths": [dict(path=p, frames=f, launches_per_frame={op: c / f for op, c in n.items()})
                  for p, f, n in DISNEY_RUNS],
    }, {
        "name": "pt_shade",
        "route": "cuda",
        "source": "ti_raytrace_tpu_torch/csrc/pt_shade.cu",
        "replaces": None,  # the JAX package's PT shading is plain XLA
        "launches": sum(sum(c.values()) for _, _, c in SHADE_RUNS),
        "library_ms": None,  # no PyTorch call shades a path tracer's hits
        "rows": shade_rows,
        "paths": [dict(path=p, frames=f, launches_per_frame={op: c / f for op, c in n.items()})
                  for p, f, n in SHADE_RUNS],
    }, {
        "name": "coherence_key",
        "route": "cuda",
        "source": "ti_raytrace_tpu_torch/csrc/coherence_key.cu",
        "replaces": None,  # the JAX package's coherence key is plain XLA
        "launches": sum(sum(c.values()) for _, _, c in ORDER_RUNS),
        "library_ms": None,  # no PyTorch call computes a morton code
        "rows": order_rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
