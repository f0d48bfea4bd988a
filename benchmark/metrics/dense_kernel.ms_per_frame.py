"""dense_kernel.ms_per_frame: device time of the dense kernel
(csrc/dense_trace.cu, events named dense_sweep_kernel) in the profiled
calls over their frames (torch.profiler, CUPTI)."""

KERNEL = "dense_sweep_kernel"


def read(rec):
    if rec.trace is None:
        return None
    secs = rec.trace.kernel_s(KERNEL)
    return secs / rec.trace_frames * 1e3 if secs > 0 else None
