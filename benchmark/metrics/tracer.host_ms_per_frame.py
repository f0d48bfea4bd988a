"""tracer.host_ms_per_frame: the tracer's host time in the
device-profiled calls over their frames: the summed wall time of the
program's trace.* spans (coherence order, pack, kernel launch, unsort,
sphere tail, attribute gather)."""

from harness import spans


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    ns = sum(r.t1_ns - r.t0_ns for r in records if r.name.startswith("trace."))
    return ns * 1e-6 / rec.trace_frames
