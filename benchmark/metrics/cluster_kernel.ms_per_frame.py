"""cluster_kernel.ms_per_frame: device time of the cluster kernel
(csrc/cluster_trace.cu, events named cluster_trace_kernel) in the
profiled calls over their frames (torch.profiler, CUPTI)."""

KERNEL = "cluster_trace_kernel"


def read(rec):
    if rec.trace is None:
        return None
    secs = rec.trace.kernel_s(KERNEL)
    return secs / rec.trace_frames * 1e3 if secs > 0 else None
