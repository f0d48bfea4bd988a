"""Where a BDPT frame's time goes, on the veach_bdpt scene:

    python -m ti_raytrace_tpu_torch.tools.profile_bdpt \
        [--size 512] [--frames 4] [--device cuda]

Every frame is `bdpt_rgb.render_film_frames(n_frames=1)`: render_frame_sliced
in 2 slices with the scene's walk compaction and shadow cap, accumulated
into the film, as the CLI and the golden gate render it.  After one
warm-up frame (the kernel build on a fresh checkout) the tool reports,
per frame:

  * wall and process CPU time over `--frames` uninstrumented frames, and
    the peak device memory of those frames (on a card they replay the
    frame's CUDA graph, as the CLI's frames after the first do);
  * top-level torch calls of one eager frame (attribute reads excluded), in
    total and by the program's spans (`count_ops`), counted by a
    TorchFunctionMode; a call is charged to the innermost span open when
    it runs (a pdf evaluated inside a walk step counts as bdpt.pdf);
  * on CUDA, from torch.profiler over one more frame: the device kernels
    launched, their summed device time and its share of that frame's wall
    time, the cluster_trace and threefry kernels' times and launches, and
    the torch ops with the most device time.

Prints a readable report to stderr and, last on stdout, one JSON line.
"""

import argparse
import collections
import json
import sys
import time

import torch
from torch.overrides import TorchFunctionMode

from ti_raytrace_tpu_torch import metrics

OTHER = "other"  # calls outside every span


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class _OpCounter(TorchFunctionMode):
    """Counts top-level torch calls by the innermost recording span open
    at each call (metrics.current_span), OTHER outside every span."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") != "__get__":
            self.counts[metrics.current_span() or OTHER] += 1
        return func(*args, **(kwargs or {}))


def count_ops(render):
    """Runs render() with the program's spans recording; returns {span
    name: top-level torch calls made while it was the innermost open
    span}, OTHER included.  Works for any render path: BDPT's sections
    are bdpt.walk, bdpt.shadow_requests, bdpt.pdf, bdpt.mis, trace.*,
    bdpt.splat and bdpt.connections (the strategy bodies); the path
    tracer's pt.camera, pt.bounce, pt.shade, pt.nee, pt.flush_compact,
    pt.env and film.accumulate."""
    counter = _OpCounter()
    with metrics.recording(), counter:
        render()
    return dict(counter.counts.most_common())


def device_profile(render, device, top: int = 8) -> dict:
    """One render() under torch.profiler: kernels launched, their device
    time, its share of the wall time, the cluster_trace and threefry
    (csrc/rng.cu) kernels' parts and the `top` torch ops by self device
    time (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(evt):
        return evt.self_device_time_total

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for evt in prof.key_averages():
        (kernels if evt.device_type == DeviceType.CUDA else ops).append(evt)
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    trace = [e for e in kernels if "cluster_trace_kernel" in e.key]  # "void ...<256>(...)"
    draws = [e for e in kernels if "threefry_uniform_kernel" in e.key]
    ops = sorted((e for e in ops if dev_us(e) > 0), key=dev_us, reverse=True)[:top]
    return dict(
        profiled_wall_ms=wall_ms,
        device_kernels=sum(e.count for e in kernels),
        device_ms=device_ms,
        busy_share=device_ms / wall_ms,
        cluster_trace_ms=sum(dev_us(e) for e in trace) / 1e3,
        cluster_trace_launches=sum(e.count for e in trace),
        threefry_ms=sum(dev_us(e) for e in draws) / 1e3,
        threefry_launches=sum(e.count for e in draws),
        top_ops_ms={e.key: dev_us(e) / 1e3 for e in ops},
    )


def main(argv=None):
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.scenes import make_camera, veach_bdpt
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    scene, cfg = veach_bdpt(device)
    spec, cam = make_camera(scene, cfg, args.size, args.size)
    state = dict(film=film_mod.new_film(args.size, args.size, device=device), overflow=0)

    def render():
        state["film"], ov = bdpt_rgb.render_film_frames(
            scene, spec, cam, state["film"], n_frames=1, n_slices=2,
            walk_compaction=cfg.bdpt_walk_compaction, shadow_cap=cfg.bdpt_shadow_cap)
        state["overflow"] += ov

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    render()  # warm-up
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    wall, cpu = [], []
    for _ in range(args.frames):
        t0, c0 = time.perf_counter(), time.process_time()
        render()
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        cpu.append((time.process_time() - c0) * 1e3)
    out = dict(size=args.size, frames=args.frames, wall_ms=wall, cpu_ms=cpu)
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"wall ms/frame: {', '.join(f'{w:.3f}' for w in wall)}; process CPU ms/frame: "
        f"{', '.join(f'{c:.3f}' for c in cpu)}")

    sections = count_ops(render)
    out["ops"] = sum(sections.values())
    out["ops_by_section"] = sections
    log(f"top-level torch calls per frame: {out['ops']}")
    for s, n in sections.items():
        log(f"  {s:22s} {n:8d}")

    if cuda:
        out.update(device_profile(render, device))
        log(f"device: {out['device_kernels']} kernels, {out['device_ms']:.3f} ms over "
            f"{out['profiled_wall_ms']:.3f} ms wall (busy {out['busy_share']:.3f}); "
            f"cluster_trace {out['cluster_trace_ms']:.3f} ms in "
            f"{out['cluster_trace_launches']} launches; threefry {out['threefry_ms']:.3f} ms in "
            f"{out['threefry_launches']} launches")
        for k, ms in out["top_ops_ms"].items():
            log(f"  {ms:9.3f} ms  {k}")
        out["device"] = torch.cuda.get_device_name(device)
    out["overflow"] = int(state["overflow"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
