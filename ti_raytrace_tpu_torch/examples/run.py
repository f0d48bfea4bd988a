"""CLI render harness for the ported scenes:

    python -m ti_raytrace_tpu_torch.examples.run benchmark_100k \
        --size 512 --frames 128 --group 16 --device cuda --out /tmp/r.png
    python -m ti_raytrace_tpu_torch.examples.run veach_bdpt \
        --size 512 --frames 32 --device cuda --out /tmp/veach-bdpt.png
    python -m ti_raytrace_tpu_torch.examples.run veach_bdpt --integrator pt_rgb \
        --size 512 --frames 64 --device cuda --out /tmp/veach.png

Progressive rendering, 1 spp per frame, with the scene's own integrator
unless --integrator overrides it.  The path tracer (`pt_rgb`): scenes
with a merged group and a compaction schedule (the benchmark) render in
merged groups; the others render `batch` frames per call of
`render_film_frames` (the scene's batch, or 8), on the exact path when
they have no schedule; NEE is on when the scene has a material that
takes it (`has_nee_materials`).  BDPT (`bdpt_rgb`): every frame is
`render_frame_sliced` in 2 slices with the scene's walk compaction and
shadow cap, accumulated into the film, `batch` frames per call (the
scene's batch, or 4).  The first call is a warm-up (it includes the
kernel build on a fresh checkout); ms/frame is timed over the remaining
calls, each ending in a device synchronize.  Prints one JSON line with
ms/frame and the overflow count (compaction kills for PT, the walk
compaction overflow plus capped shadow lanes for BDPT; non-zero means
live paths were cut: a bias).
"""

import argparse
import json
import time

import torch

from ti_raytrace_tpu_torch import film as film_mod
from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera
from ti_raytrace_tpu_torch.integrators import bdpt_rgb, pt_rgb


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("example")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--integrator", default=None, help="override the scene's integrator")
    ap.add_argument("--group", type=int, default=None,
                    help="frames per merged group (default: the scene's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png")
    args = ap.parse_args(argv)
    if args.example not in EXAMPLES:
        raise NotImplementedError(
            f"scene {args.example!r} is outside the ported slice (ported: "
            f"{sorted(EXAMPLES)}; ROADMAP 'to port': the dense tracer + "
            f"cornell/single_model slice and the scenes after it)")

    device = torch.device(args.device)
    scene, cfg = EXAMPLES[args.example](device)
    integrator = args.integrator or cfg.integrator
    if integrator not in ("pt_rgb", "bdpt_rgb"):
        raise NotImplementedError(
            f"integrator {integrator!r} is outside the ported slice (ported: "
            f"pt_rgb, bdpt_rgb; ROADMAP 'to port': the spectral items)")
    spec, cam = make_camera(scene, cfg, args.size, args.size)
    bdpt = integrator == "bdpt_rgb"
    nee = None if bdpt else pt_rgb.has_nee_materials(scene)
    group = args.group or cfg.group or 0
    merged = not bdpt and bool(cfg.compaction) and group > 1
    batch = group if merged else (cfg.batch or (4 if bdpt else 8))
    if merged and args.frames % group:
        raise ValueError(f"--frames {args.frames} is not a multiple of --group {group}")

    fl = film_mod.new_film(args.size, args.size, seed=args.seed, device=device)
    kills, times, counts = 0, [], []
    while fl.frame < args.frames:
        n = min(batch, args.frames - fl.frame)
        t0 = time.perf_counter()
        if bdpt:
            fl, ov = bdpt_rgb.render_film_frames(
                scene, spec, cam, fl, n_frames=n, n_slices=2,
                walk_compaction=cfg.bdpt_walk_compaction, shadow_cap=cfg.bdpt_shadow_cap)
        elif merged:
            fl, ov = pt_rgb.render_film_frames_merged(
                scene, spec, cam, fl, n_frames=n, group=group, compaction=cfg.compaction,
                nee=nee, pay_divisors=cfg.pay_divisors)
        else:
            fl, ov = pt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=n,
                                               compaction=cfg.compaction, nee=nee)
        _sync(device)
        times.append(time.perf_counter() - t0)
        counts.append(n)
        kills += ov
        print(f"frame {fl.frame}/{args.frames}  {times[-1] / n * 1e3:.3f} ms/frame"
              f"  {'walk overflow' if bdpt else 'overflow kills'} {ov}", flush=True)
    film_mod.save_png(fl, args.out, exposure=cfg.exposure)
    timed = slice(1, None) if len(times) > 1 else slice(None)
    print(json.dumps(dict(
        scene=args.example, integrator=integrator, nee=nee, size=args.size,
        frames=fl.frame, group=group if merged else None, batch=batch,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        warmup_ms_per_frame=times[0] / counts[0] * 1e3,
        ms_per_frame=sum(times[timed]) / sum(counts[timed]) * 1e3,
        overflow_kills=kills, out=args.out,
    )))


if __name__ == "__main__":
    main()
