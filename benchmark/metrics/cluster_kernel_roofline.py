"""cluster_kernel_roofline: the cluster kernel's share of its roofline, in
%, over its launches in the device-profiled calls: the summed least time
of the launches (harness/work.py: the bytes that a launch of its width
must move, over the card's memory rate) over their summed device time
(the CUPTI durations of the events named cluster_trace_kernel, the same
launches in the same order).  The peaks are the published ones
(harness/peaks.json); on a card without an entry there, or where the
recorded launches and the traced kernels differ in number, nothing is
read."""

from harness import work

KERNEL = "cluster_trace_kernel"


def read(rec):
    if rec.trace is None or not rec.launches or rec.peak is None:
        return None
    secs = [e - s for s, e, n in rec.trace.device if KERNEL in n]
    if len(secs) != len(rec.launches) or sum(secs) <= 0:
        return None
    least = sum(work.bound_s(work.launch_bytes(n, bounded), rec.peak)
                for n, bounded in rec.launches)
    return 100.0 * least / sum(secs)
