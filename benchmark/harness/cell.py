"""One run of one cell: set-up, warm-up, the measured window, the traced
calls, the comparison with the plain reference and the result line.

A run is one process and a closed loop: a renderer's user waits for each
call before issuing the next.  Set-up (imports, CUDA context, the
program's kernels and scene from the checkout's cache, one warm-up call
of the cell's shape) ends before the window opens.  The window renders
calls back to back for `seconds`; each call ends in a device synchronize
(and, for a preview workload, the readback), and a call that ends after
the window closes is neither timed nor counted.  With `trace`, the
window's untraced calls are followed by a fixed slice of traced calls,
K = the workload's `trace_calls`: K under the profiler recording the
card's activities alone, with the width of each cluster-kernel launch
recorded (the metrics read these); one under the torch-call counter; K
under the profiler recording the host's ops as well (the breakdown reads
these).
"""

import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

import torch

from harness import compare, counters, profile, registry

JAX_NAMES = {"jax", "jaxlib", "flax", "ti_raytrace_tpu"}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def traced_parts(k: int):
    """(first call, last call) of the traced slice's three parts, counted
    from the slice's first call: the device profile, the counted call
    and the host profile."""
    return (0, k - 1), (k, k), (k + 1, 2 * k)


def window(prog, seed: int, seconds: float, workload: dict, trace: bool, sampler,
           max_calls=None):
    """The measured window: returns the record of its calls (and of the
    traced ones).  max_calls (calibration only) ends it after so many
    calls whatever the time."""
    n = workload["frames_per_call"]
    readback = bool(workload.get("readback"))
    k = workload.get("trace_calls", 1)
    device_part, count_part, host_part = traced_parts(k)
    dev = prog.device
    rec = SimpleNamespace(frames=0, calls=0, failed=0, intervals=[], readback_s=[],
                          traces=[], host_traces=[], trace_frames=0, torch_calls=None,
                          counted_frames=0, launches=None, traced_calls=k, untraced_calls=None)
    fl = prog.new_film(seed)
    load0 = host_load()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    last = t_start
    opened = []  # the context managers of the traced part under way
    counter = None
    i = 0
    while True:
        # a traced run's slice follows the window's untraced calls, so that
        # what the profiler leaves behind slows none of them
        if trace and rec.untraced_calls is None and (
                last > deadline or (max_calls is not None and i >= max_calls - 2 * k - 1)):
            rec.untraced_calls = i
        j = i - rec.untraced_calls if rec.untraced_calls is not None else -1
        if j == device_part[0]:
            opened = [profile.profiled(rec.traces, host=False), counters.kernel_widths()]
            rec.launches = [cm.__enter__() for cm in opened][1]
        elif j == count_part[0]:
            counter = counters.CallCounter()
            opened = [counter]
            counter.__enter__()
        elif j == host_part[0]:
            opened = [profile.profiled(rec.host_traces, host=True)]
            opened[0].__enter__()
        before = fl
        fl, overflow = prog.call(fl, n)
        if readback:
            if trace:
                _sync(dev)
                r0 = time.perf_counter()
            prog.readback(fl)
            if trace:
                rec.readback_s.append(time.perf_counter() - r0)
        _sync(dev)
        now = time.perf_counter()
        if opened and j in (device_part[1], count_part[1], host_part[1]):
            for cm in reversed(opened):
                cm.__exit__(None, None, None)
            opened = []
            if j == device_part[1]:
                rec.trace_frames = k * n
            if j == count_part[1]:
                rec.torch_calls, rec.counted_frames = counter.calls, n
        if now > deadline and max_calls is None and not trace:
            break
        rec.intervals.append(now - last)
        last = now
        rec.frames += n
        rec.calls += 1
        rec.failed += n if overflow else 0
        sampler.offer(before, fl, n)
        i += 1
        if j == host_part[1] or (max_calls is not None and i >= max_calls):
            break
    for cm in reversed(opened):  # calibration's max_calls ended a traced part
        cm.__exit__(None, None, None)
    if opened and j <= device_part[1]:
        rec.traces.clear()
        rec.launches = None
    rec.window_s = last - t_start
    rec.host_load = host_load(load0)
    return rec


def host_load(since=None):
    """(process CPU seconds, wall seconds), or with `since` the change from
    that reading: how much of the window the process ran on a core."""
    now = (time.process_time(), time.perf_counter())
    if since is None:
        return now
    cpu_s, wall_s = (a - b for a, b in zip(now, since))
    return {"process_cpu_s": round(cpu_s, 3), "wall_s": round(wall_s, 3)}


def warm_up(prog, workload: dict, seed: int):
    """One call of the cell's shape (and its readback) on a film of its own."""
    fl, _ = prog.call(prog.new_film(seed), workload["frames_per_call"])
    if workload.get("readback"):
        prog.readback(fl)
    _sync(prog.device)


def run_cell(prog, workload: dict, config: dict, bench: dict, seed: int, seconds: float,
             trace: bool, setup_s: float, chips: int = 1, ref=None, max_calls=None,
             bench_dir=registry.BENCH_DIR):
    """Window, reference and result of one run on the program `prog`
    (set up and warmed up by the caller).  Returns (result dict, reference)
    so that a caller running several seeds builds the reference once."""
    from reference import render

    dev = prog.device
    sampler = compare.Sampler(seed)
    rec = window(prog, seed, seconds, workload, trace, sampler, max_calls)
    rec.setup_s = setup_s
    rec.workload, rec.config = workload, config
    cuda = torch.device(dev).type == "cuda"
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    print(f"window {rec.window_s:.3f} s: {rec.calls} calls, {rec.frames} frames; "
          f"memory peak {mem_peak} B; calls' seconds first "
          f"{rec.intervals[0] if rec.intervals else None}, least "
          f"{min(rec.intervals, default=None)}, quartiles "
          f"{statistics.quantiles(rec.intervals, n=4) if len(rec.intervals) > 1 else None}, "
          f"most {max(rec.intervals, default=None)}; "
          f"host {rec.host_load}", file=sys.stderr)
    kept = sampler.kept
    del sampler
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if ref is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = render.build(config, workload, dev)
    checks = {}
    if kept is not None:
        checks = compare.compare(
            kept, lambda hdr, frame, n: render.replay(ref, hdr, frame,
                                                      render.key_at(seed, frame), n),
            workload["limits"])
    correct = kept is not None and compare.passed(checks)
    print(f"reference {time.perf_counter() - t_ref:.3f} s (call of frame "
          f"{kept[0].frame if kept else None})", file=sys.stderr)

    with open(os.path.join(bench_dir, "harness", "peaks.json")) as f:
        rec.peak = json.load(f).get(kind)
    rec.trace = rec.traces[0] if rec.traces else None
    host_trace = rec.host_traces[0] if rec.host_traces else None
    untraced = rec.intervals[:rec.untraced_calls]
    rec.untraced_call_s = statistics.median(untraced) if untraced else None
    if rec.trace is not None:
        print(f"{rec.traced_calls} traced calls: {rec.trace.window_s:.4f} s under the "
              f"device profile, {host_trace.window_s if host_trace else None} s with the "
              f"host's ops; the window's median untraced call {rec.untraced_call_s} s",
              file=sys.stderr)

    kind_key = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.cell_metrics(bench, workload["name"], kind_key):
        value = registry.reader(m["name"], bench_dir)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": chips,
              "memory_peak_bytes": mem_peak}
    result = {"correct": correct, "attempted": rec.frames, "failed": rec.failed,
              "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s()
        device["window_s"] = rec.trace.window_s
    if trace and host_trace is not None:
        result["breakdown"] = {"device_ops": host_trace.device_ops(),
                               "idle_gaps": host_trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, ref


def jax_loaded() -> list:
    """Whole top-level names of loaded modules that are JAX or the JAX
    package (ti_raytrace_tpu_torch is neither)."""
    return sorted({m.split(".")[0] for m in sys.modules} & JAX_NAMES)


def emit(result: dict, out=sys.stdout, err=sys.stderr):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
