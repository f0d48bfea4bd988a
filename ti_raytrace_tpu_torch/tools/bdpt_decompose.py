"""BDPT strategy decomposition: the contribution of every (e, l) strategy
(twin of ti_raytrace_tpu/tools/bdpt_decompose.py).

    python -m ti_raytrace_tpu_torch.tools.bdpt_decompose --scene veach_bdpt \
        --size 64 --frames 8 [--corrected] [--unweighted] [--spectral]
        [--device cuda]

Renders one scene with the path tracer truncated at successive depths
(the exact per-depth radiance of the unidirectional estimator) and with
BDPT restricted to one (e, l) strategy at a time (one set of subpaths per
frame), then compares per-depth totals:

    PT depth k   <->  sum over { (e, l) : e + l - 2 == k }

A correctly weighted BDPT converges to PT's per-depth totals, so a fault
in one strategy's contribution or MIS weight shows as a deficit at that
strategy's depths and not as uniform noise.  `--unweighted` sets every MIS
weight to 1: each strategy alone is then a complete estimator of its
depths, which separates a fault of the contribution from one of the
weight.  `--spectral` decomposes the spectral BDPT (one wavelength per
lane, no PT truth).  `--scene diagbox` is a closed gray box with one
material and one emitting quad, where the reference's material-index MIS
quirk is inert.  The tracer is the scene's own (`accel` dispatches on the
prim count) on either device.
"""

import argparse
import sys
import time

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pt_depth_decomposition(scene, spec, cam, frames, nee=True, corrected=False):
    """Mean radiance added at each path depth, from successive truncations
    of the path tracer: (the deepest truncation's mean, the per-depth
    list).  corrected=True divides by the samplers' true densities, the
    unbiased truth to hold the corrected BDPT against."""
    from ti_raytrace_tpu_torch.camera import ray_directions, ray_origins
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    means = []
    for k in range(1, 9):  # BDPT compares depths <= 5 (at most 6 edges)
        total = 0.0
        for f in range(frames):
            k_cam, k_path = rng.split(rng.PRNGKey(100 + f))
            o = ray_origins(spec, cam).T
            d = ray_directions(spec, cam, f + 1, k_cam).T
            rad = pt_rgb.trace_paths(scene, o, d, k_path, max_depth=k, nee=nee,
                                     corrected=corrected)
            total += float(rad.mean())
        means.append(total / frames)
    per_depth = [means[0]] + [b - a for a, b in zip(means, means[1:])]
    return means[-1], per_depth


def strategy_pairs():
    """Every (e, l) of the full-depth BDPT, in evaluation order."""
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb as B

    return [(e, l)
            for e in range(1, B.EYE_MAX_DEPTH + 1)
            for l in range(0, B.LIGHT_MAX_DEPTH + 1)
            if not ((l == 1 and e == 1) or l + e - 2 < 0 or l + e - 2 > B.MAX_DEPTH)]


def bdpt_strategy_decomposition(scene, spec, cam, frames, corrected=False, spectral=False,
                                unweighted=False):
    """Mean radiance per (e, l) strategy, the strategies of a frame sharing
    its subpaths.  spectral=True runs the spectral machinery (a SpecCtx at
    emitter scale 1); the strategy sums go through the CIE sensor as in
    bdpt_spec's frame."""
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb as B

    spec_ctx_fn = None
    if spectral:
        from ti_raytrace_tpu_torch.integrators.bdpt_spec import make_spec_ctx_fn

        spec_ctx_fn = make_spec_ctx_fn(device=scene.device)
    N = spec.width * spec.height
    pairs = strategy_pairs()
    out = {p: 0.0 for p in pairs}
    for f in range(frames):
        k_eye, k_light, k_conn = rng.split(rng.PRNGKey(100 + f), 3)
        ctx = None
        if spectral:
            k_lam, k_eye = rng.split(k_eye)
            ctx = spec_ctx_fn(k_lam, N)
        eye, eye_count, _ = B.build_eye_path(scene, spec, cam, f + 1, k_eye,
                                             corrected=corrected, spec_ctx=ctx)
        light, light_count, _ = B.build_light_path(scene, N, k_light, corrected=corrected,
                                                   spec_ctx=ctx)
        for pair in pairs:
            radiance, splat, _ = B._connections(
                scene, spec, cam, eye, eye_count, light, light_count, k_conn,
                corrected=corrected, unweighted=unweighted, spec_ctx=ctx,
                strategies=lambda e, l, only=pair: (e, l) == only)
            if spectral:
                radiance = ctx.to_rgb(radiance)
            # the image is the radiance (reshaped) plus the splat, so its
            # mean is the sum of the two means (both over W * H * 3 values)
            out[pair] += float(radiance.mean() + splat.mean())
    return {p: v / frames for p, v in out.items()}


def _diag_box_host() -> dict:
    """Host dict of the diagnostic scene: an inward-facing cube of half-size
    2 under one Disney material (index 0), and a 1 x 1 emitting quad just
    below its ceiling.  No glass and one surface material, so a correct MIS
    makes BDPT converge to PT here."""
    from ti_raytrace_tpu_torch.core import constants as C
    from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder

    s = 2.0
    corners = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                       np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = []
    for a, b, c, d in quads:
        tris.append([corners[a], corners[b], corners[c]])
        tris.append([corners[a], corners[c], corners[d]])
    pos = np.asarray(tris, np.float32)
    bld = SceneBuilder()
    bld.add_triangles(pos, np.zeros_like(pos), np.zeros((pos.shape[0], 3, 2), np.float32),
                      MaterialRec(C.MAT_DISNEY, color=(0.6, 0.6, 0.6), p0=0.0, p1=0.6))
    e = 0.5
    light = np.asarray(
        [[[-e, s - 0.1, -e], [e, s - 0.1, -e], [e, s - 0.1, e]],
         [[-e, s - 0.1, -e], [e, s - 0.1, e], [-e, s - 0.1, e]]], np.float32)
    bld.add_triangles(light, np.zeros_like(light), np.zeros((2, 3, 2), np.float32),
                      MaterialRec(C.MAT_LIGHT, color=(8.0, 8.0, 8.0)))
    return bld.build_host()


def _diag_box(device="cpu"):
    """(SceneData on `device`, ExampleConfig) of the diagnostic box, seen
    from inside: distance 1 from the origin."""
    from ti_raytrace_tpu_torch.examples.scenes import ExampleConfig
    from ti_raytrace_tpu_torch.scene.data import device_scene

    return device_scene(_diag_box_host(), device), ExampleConfig(
        "diagbox", "bdpt_rgb", fixed_scale=1.0, fixed_target=(0.0, 0.0, 0.0))


def _by_depth(strat):
    depth = {}
    for (e, l), v in strat.items():
        depth[e + l - 2] = depth.get(e + l - 2, 0.0) + v
    return depth


def _print_strategies(strat):
    print("\n(e, l) strategy means:")
    for e, l in sorted(strat):
        print(f"  e={e} l={l} (depth {e + l - 2}): {strat[(e, l)]:.6f}")


def main(argv=None):
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="veach_bdpt",
                    choices=sorted(EXAMPLES) + ["diagbox"])
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--corrected", action="store_true")
    ap.add_argument("--spectral", action="store_true",
                    help="decompose the spectral BDPT (no PT truth)")
    ap.add_argument("--unweighted", action="store_true",
                    help="every MIS weight 1: each strategy alone then estimates its depths")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    scene, cfg = _diag_box(device) if args.scene == "diagbox" else EXAMPLES[args.scene](device)
    spec, cam = make_camera(scene, cfg, args.size, args.size)
    head = f"{args.scene} {args.size}px x{args.frames} frames on {device.type}"

    if args.spectral:
        t0 = time.time()
        strat = bdpt_strategy_decomposition(scene, spec, cam, args.frames,
                                            corrected=args.corrected, spectral=True,
                                            unweighted=args.unweighted)
        log(f"spectral BDPT decomposition in {time.time() - t0:.0f}s")
        print(f"\n=== {head} (SPECTRAL) ===")
        print(f"spectral BDPT total mean: {sum(strat.values()):.5f}")
        for k, v in sorted(_by_depth(strat).items()):
            print(f"depth {k} ({k + 1} edges): {v:.6f}")
        _print_strategies(strat)
        return

    t0 = time.time()
    pt_total, _ = pt_depth_decomposition(scene, spec, cam, args.frames,
                                         corrected=args.corrected)
    # per-edge truth: without NEE, PT(max_depth=k) - PT(max_depth=k-1) is the
    # k-edge path total (with NEE the two techniques' truncation windows
    # overlap and the split is mixed)
    _, pt_edge = pt_depth_decomposition(scene, spec, cam, args.frames, nee=False,
                                        corrected=args.corrected)
    log(f"PT decomposition in {time.time() - t0:.0f}s")
    t0 = time.time()
    strat = bdpt_strategy_decomposition(scene, spec, cam, args.frames,
                                        corrected=args.corrected,
                                        unweighted=args.unweighted)
    log(f"BDPT decomposition in {time.time() - t0:.0f}s")

    total = sum(strat.values())
    print(f"\n=== {head}{' (corrected)' if args.corrected else ''}"
          f"{' (unweighted)' if args.unweighted else ''} ===")
    print(f"PT total mean (NEE, depth 8 of {pt_rgb.MAX_DEPTH}): {pt_total:.5f}")
    print(f"BDPT total mean: {total:.5f} (ratio {total / max(pt_total, 1e-9):.3f})")
    print("\nedges | PT(noNEE) |     BDPT | ratio   [BDPT depth d == d+1 edges]")
    for k, b in sorted(_by_depth(strat).items()):
        p = pt_edge[k] if k < len(pt_edge) else 0.0
        print(f"{k + 1:5d} | {p:9.5f} | {b:8.5f} | "
              f"{b / p if abs(p) > 1e-9 else float('nan'):.3f}")
    _print_strategies(strat)


if __name__ == "__main__":
    main()
