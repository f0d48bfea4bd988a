"""The device trace of the traced calls, from torch.profiler (CUPTI), reduced
to what the per-layer metrics and the breakdown read: every device
activity's interval and name, the host ops' intervals, and the wall time
of the profiled stretch.  The metrics read a trace of the card's
activities alone; recording the host's ops as well slows the host-bound
calls (by up to 2x), so only the breakdown reads such a trace, taken
over other calls."""

import bisect
import collections
import contextlib
import time

from harness import stats

TOP = 10
NAME = 120  # characters of a device activity's name kept in the breakdown


class Trace:
    """Device intervals [(start_s, end_s, name)], host op intervals
    [(start_s, end_s, name)] and the profiled wall time window_s; times in
    seconds on the profiler's clock."""

    def __init__(self, device, host, window_s: float):
        self.device = sorted(device)
        self.host = sorted(host)
        self.window_s = window_s
        self.start = min([s for s, _, _ in self.device + self.host], default=0.0)

    def busy_s(self) -> float:
        return stats.union_length([(s, e) for s, e, _ in self.device])

    def kernel_s(self, substring: str) -> float:
        """Summed device time of activities whose name holds `substring`."""
        return sum(e - s for s, e, n in self.device if substring in n)

    def device_ops(self):
        """[[name, seconds], ...]: the device activities that took most time,
        summed by name."""
        by = collections.Counter()
        for s, e, n in self.device:
            by[n[:NAME]] += e - s
        return [[n, t] for n, t in by.most_common(TOP)]

    def idle_gaps(self):
        """[[host activity, seconds], ...]: the device's idle time inside
        the traced stretch, summed by what the host was doing at each gap's
        middle: the innermost host op open there, else the host op that
        came next ("python before <op>")."""
        if not self.device:
            return []
        end = max(e for _, e, _ in self.device + self.host)
        starts = [s for s, _, _ in self.host]
        by = collections.Counter()
        for g0, g1 in stats.gaps([(s, e) for s, e, _ in self.device], self.start, end):
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid)
            label = None
            for j in range(i - 1, max(-1, i - 64), -1):
                s, e, n = self.host[j]
                if e >= mid:
                    label = n
                    break
            if label is None:
                label = "python before " + (self.host[i][2] if i < len(self.host) else "end")
            by[label] += g1 - g0
        return [[n, t] for n, t in by.most_common(TOP)]


@contextlib.contextmanager
def profiled(out: list, host: bool):
    """Profile the block: the card's activities, and with `host` the host's
    ops too (on a machine without a card, the host's ops alone); appends
    its Trace to `out` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = []
    if host or not torch.cuda.is_available():
        acts.append(ProfilerActivity.CPU)
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        window = time.perf_counter() - t0
        prof.stop()
        out.append(reduce(prof, window))


def reduce(prof, window_s: float) -> Trace:
    """The profiler's raw events as a Trace (device activities: every event
    the profiler puts on a CUDA device; host: the CPU ops)."""
    from torch.autograd import DeviceType

    device, host = [], []
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        raise RuntimeError("torch.profiler gave no kineto results to read")
    for ev in results.events():
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            device.append((s, e, ev.name()))
        elif ev.device_type() == DeviceType.CPU:
            host.append((s, e, ev.name()))
    return Trace(device, host, window_s)
