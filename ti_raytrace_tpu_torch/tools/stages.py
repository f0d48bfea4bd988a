"""Where a render call's time goes, stage by stage:

    python -m ti_raytrace_tpu_torch.tools.stages benchmark_100k --frames 16 \
        [--integrator pt_rgb] [--size 512] [--calls 1] [--device cuda] [--out f.json]

Renders calls of `--frames` frames through the CLI's `examples/run.
render_batch` (the scene's own schedule, as the benchmark drives it).
After one warm-up call it counts each stage's top-level torch calls over
one call (`profile_bdpt.count_ops`, charged to the innermost open span),
then profiles `--calls` calls with the card's activities alone
(torch.profiler, CUPTI), the program's spans recording (metrics.span),
and lays the spans over the device trace: both carry Unix-epoch ns.  Per
stage (the innermost open span at each instant) and frame: the host's
time there, the card's busy and idle time under it, the spans, the syncs
and the torch calls; the allocator's retries, allocations and frees per
call (render.call's counters); the share of the card's idle time that
lies under a stage other than render.call, and under a leaf span (one
with no child span); and the share of the calls' wall time inside
render.call.  Prints a table to stderr and, last on stdout, one JSON
line.  Needs a CUDA card for the device columns; on the CPU they read 0.
"""

import argparse
import bisect
import collections
import json
import sys
import time

import torch

from ti_raytrace_tpu_torch import metrics

ROOT = "render.call"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def union(intervals):
    """Sorted disjoint (start, end) covering `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def covered(busy, starts, s, e) -> float:
    """Length of [s, e) under the disjoint sorted intervals `busy` (starts:
    their start points)."""
    total = 0.0
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    while i < len(busy) and busy[i][0] < e:
        total += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return total


def innermost(records):
    """[(start_ns, end_ns, name, leaf)]: the stretches in which each span
    is the innermost open one; leaf: the span has no child span."""
    kids = collections.defaultdict(list)
    for r in records:
        if r.parent is not None:
            kids[r.parent].append(r)
    out = []
    for r in records:
        cur = r.t0_ns
        ch = sorted(kids[r.id], key=lambda c: c.t0_ns)
        for c in ch:
            if c.t0_ns > cur:
                out.append((cur, c.t0_ns, r.name, False))
            cur = max(cur, c.t1_ns)
        if r.t1_ns > cur:
            out.append((cur, r.t1_ns, r.name, not ch))
    return sorted(out)


def stage_table(records, device, calls, frames: int) -> dict:
    """records: the spans of the profiled calls; device: the card's
    activity intervals (ns); calls: each call's (start, end) wall interval
    (ns), synchronize included; frames: frames rendered in them.  Returns
    {"stages": {name: per-frame ms and counts}, "idle_ms", "idle_in_stage",
    "idle_in_leaf", "wall_in_root"}."""
    busy = union(device)
    starts = [s for s, _ in busy]
    rows = collections.defaultdict(lambda: dict(host_ms=0.0, busy_ms=0.0, idle_ms=0.0,
                                                spans=0))
    for r in records:
        rows[r.name]["spans"] += 1
    idle_stage = idle_leaf = 0.0
    for s, e, name, leaf in innermost(records):
        b = covered(busy, starts, s, e)
        row = rows[name]
        row["host_ms"] += e - s
        row["busy_ms"] += b
        row["idle_ms"] += e - s - b
        if name != ROOT:
            idle_stage += e - s - b
            idle_leaf += (e - s - b) if leaf else 0.0
    wall = sum(e - s for s, e in calls)
    idle = wall - sum(covered(busy, starts, s, e) for s, e in calls)
    in_root = sum(r.t1_ns - r.t0_ns for r in records if r.name == ROOT and r.parent is None)
    stages = {n: dict(host_ms=v["host_ms"] * 1e-6 / frames, busy_ms=v["busy_ms"] * 1e-6 / frames,
                      idle_ms=v["idle_ms"] * 1e-6 / frames, spans=v["spans"] / frames)
              for n, v in sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"])}
    return dict(stages=stages, idle_ms=idle * 1e-6 / frames,
                idle_in_stage=idle_stage / idle if idle > 0 else None,
                idle_in_leaf=idle_leaf / idle if idle > 0 else None,
                wall_in_root=in_root / wall if wall > 0 else None)


def allocator(records) -> dict:
    """Per call: the allocator's counters' growth over render.call."""
    out = collections.Counter()
    roots = [r for r in records if r.name == ROOT and r.attrs.get("alloc_after")]
    for r in roots:
        for k, v in r.attrs["alloc_after"].items():
            out[k] += v - r.attrs["alloc_before"].get(k, 0)
    return {k: v / len(roots) for k, v in out.items()} if roots else {}


def main(argv=None):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import render_batch
    from ti_raytrace_tpu_torch.examples.scenes import example_cached, make_camera
    from ti_raytrace_tpu_torch.tools.profile_bdpt import count_ops

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene")
    ap.add_argument("--integrator", default=None, help="override the scene's integrator")
    ap.add_argument("--frames", type=int, required=True, help="frames per call")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--calls", type=int, default=1, help="device-profiled calls")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    scene, cfg = example_cached(args.scene, device)
    integrator = args.integrator or cfg.integrator
    spec, cam = make_camera(scene, cfg, args.size, args.size)
    state = dict(film=film_mod.new_film(args.size, args.size, seed=1, device=device))

    def call():
        state["film"], _ = render_batch(scene, cfg, spec, cam, state["film"], args.frames,
                                        integrator, cfg.group or 0)
        if cuda:
            torch.cuda.synchronize(device)

    call()  # warm-up (kernel builds on a fresh checkout)
    ops = count_ops(call)
    metrics.clear_spans()
    calls = []
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        for _ in range(args.calls):
            t0 = time.time_ns()
            call()
            calls.append((t0, time.time_ns()))
    records = metrics.spans()
    events = prof.profiler.kineto_results.events()
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.device_type() == DeviceType.CUDA]
    frames = args.calls * args.frames
    out = dict(scene=args.scene, integrator=integrator, frames_per_call=args.frames,
               size=args.size, calls=args.calls,
               device=torch.cuda.get_device_name(device) if cuda else "cpu",
               **stage_table(records, dev, calls, frames),
               syncs_per_frame=sum(r.name.startswith("sync.") for r in records) / frames,
               torch_calls_per_frame={k: v / args.frames for k, v in ops.items()},
               allocator_per_call=allocator(records))
    log(f"{args.scene} {integrator}, {args.frames}-frame calls at {args.size}^2 on "
        f"{out['device']}: idle {out['idle_ms']:.3f} ms/frame, under a stage "
        f"{out['idle_in_stage']}, under a leaf {out['idle_in_leaf']}; wall in {ROOT} "
        f"{out['wall_in_root']}; syncs/frame {out['syncs_per_frame']}; allocator per call "
        f"{out['allocator_per_call']}")
    log(f"{'stage':24s} {'host ms':>9s} {'busy ms':>9s} {'idle ms':>9s} {'spans':>8s} "
        f"{'calls':>9s}   (per frame)")
    for name, row in out["stages"].items():
        log(f"{name:24s} {row['host_ms']:9.3f} {row['busy_ms']:9.3f} {row['idle_ms']:9.3f} "
            f"{row['spans']:8.2f} {out['torch_calls_per_frame'].get(name, 0):9.1f}")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
