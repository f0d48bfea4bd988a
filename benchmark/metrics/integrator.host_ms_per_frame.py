"""integrator.host_ms_per_frame: the integrators' own host time in the
device-profiled calls over their frames: the self time (duration less
the part covered by child spans, the tracer's and the device reads'
among them) of the program's pt.*, bdpt.* and film.* spans."""

from harness import spans

PREFIXES = ("pt.", "bdpt.", "film.")


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    own = spans.self_ns(records)
    ns = sum(own[r.id] for r in records if r.name.startswith(PREFIXES))
    return ns * 1e-6 / rec.trace_frames
