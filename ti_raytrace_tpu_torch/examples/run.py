"""CLI render harness for the ported slice:

    python -m ti_raytrace_tpu_torch.examples.run benchmark_100k \
        --size 512 --frames 128 --group 16 --device cuda --out /tmp/r.png

Progressive merged rendering (1 spp per frame, frames traced in merged
groups) of the 100k-triangle benchmark.  The first group is a warm-up
(it includes the kernel build on a fresh checkout); ms/frame is timed
over the remaining groups, each ending in a device synchronize.  Prints
one JSON line with ms/frame and the compaction overflow kill count
(non-zero means the schedule cut live paths: a depth bias).
"""

import argparse
import json
import time

import torch

from ti_raytrace_tpu_torch import film as film_mod
from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera
from ti_raytrace_tpu_torch.integrators import pt_rgb


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("example")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=128)
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
    spec, cam = make_camera(scene, cfg, args.size, args.size)
    group = args.group or cfg.group
    if args.frames % group:
        raise ValueError(f"--frames {args.frames} is not a multiple of --group {group}")

    fl = film_mod.new_film(args.size, args.size, seed=args.seed, device=device)
    kills, times = 0, []
    for _ in range(args.frames // group):
        t0 = time.perf_counter()
        fl, ov = pt_rgb.render_film_frames_merged(
            scene, spec, cam, fl, n_frames=group, group=group,
            compaction=cfg.compaction, pay_divisors=cfg.pay_divisors,
        )
        _sync(device)
        times.append(time.perf_counter() - t0)
        kills += ov
        print(f"frame {fl.frame}/{args.frames}  {times[-1] / group * 1e3:.3f} ms/frame"
              f"  overflow kills {ov}", flush=True)
    film_mod.save_png(fl, args.out, exposure=cfg.exposure)
    timed = times[1:] or times
    print(json.dumps(dict(
        scene=args.example, size=args.size, frames=fl.frame, group=group,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        warmup_ms_per_frame=times[0] / group * 1e3,
        ms_per_frame=sum(timed) / (len(timed) * group) * 1e3,
        overflow_kills=kills, out=args.out,
    )))


if __name__ == "__main__":
    main()
