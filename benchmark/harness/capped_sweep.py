"""The capped shadow sweeps of the device-profiled calls, for the
`shadow_sweep.*` and `shadow_cap.*` metrics: the program's
dense_trace._sweep spans that carry `capped=True` (ops/dense_trace.
trace_planar_capped, the BDPT shadow batch under a shadow cap), and the
CUPTI durations of their dense-kernel launches.

The launching spans (n > 0), in the order they closed, are matched one
for one with the events named dense_sweep_kernel in the order they
started, as `dense_kernel_roofline` matches them; the capped ones are
then picked out.  None where the program recorded no such span, or
where the launches and the kernel events differ in number."""

from harness import spans

KERNEL = "dense_sweep_kernel"
SPAN = "dense_trace._sweep"


def capped_spans(rec):
    """The attributes of the capped sweeps' spans, or None."""
    records = spans.device_profiled(rec)
    if records is None:
        return None
    capped = [r.attrs for r in records if r.name == SPAN and r.attrs.get("capped")]
    return capped or None


def capped_launches(rec):
    """[(span attributes, kernel seconds)] of the capped sweeps' launches,
    or None."""
    if rec.trace is None:
        return None
    records = spans.device_profiled(rec)
    if records is None:
        return None
    launched = [r.attrs for r in records if r.name == SPAN and r.attrs.get("n", 0) > 0]
    secs = [e - s for s, e, n in rec.trace.device if KERNEL in n]
    if not launched or len(secs) != len(launched):
        return None
    picked = [(a, s) for a, s in zip(launched, secs) if a.get("capped")]
    return picked or None
