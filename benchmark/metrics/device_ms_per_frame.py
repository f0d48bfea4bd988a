"""device_ms_per_frame: the union of the device's activity intervals in
the profiled calls over their frames (torch.profiler, CUPTI)."""


def read(rec):
    if rec.trace is None or not rec.trace.device:
        return None
    return rec.trace.busy_s() / rec.trace_frames * 1e3
