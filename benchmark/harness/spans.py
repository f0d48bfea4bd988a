"""The program's own spans over the device-profiled calls of a traced run,
for the per-layer metrics that read them.

The program (ti_raytrace_tpu_torch.metrics) records a span at each stage
of its render path while a profiler session is open: name, id, parent
id, call id, start and end in Unix-epoch ns (the profiler's clock) and
attributes.  The traced slice opens the profiler for its K
device-profiled calls and again for its K host-profiled calls, so the
program records both; these readers take the spans of the last K calls
(root spans `render.call`) that end before the host-profiled slice's
first event.  A program that records no spans (an older commit) gives
None, and so does every metric read from them."""

import collections

from harness import stats

ROOT = "render.call"


def recorded():
    """Every span the program has recorded in this process, or None."""
    from ti_raytrace_tpu_torch import metrics

    read = getattr(metrics, "spans", None)
    return read() if read is not None else None


def device_profiled(rec, records=None):
    """The spans of the K device-profiled calls of `rec` (from `records`,
    default: the program's), or None where there are none."""
    if rec.trace is None or not rec.trace_frames:
        return None
    records = recorded() if records is None else records
    if not records:
        return None
    host = rec.host_traces[0] if rec.host_traces else None
    end_ns = host.start * 1e9 if host is not None and (host.device or host.host) else None
    roots = [r for r in records if r.name == ROOT and r.parent is None
             and (end_ns is None or r.t1_ns < end_ns)]
    calls = {r.id for r in roots[-rec.traced_calls:]}
    picked = [r for r in records if r.call in calls]
    return picked or None


def self_ns(records) -> dict:
    """{span id: its duration less the part of its interval that its
    child spans cover}."""
    children = collections.defaultdict(list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append((r.t0_ns, r.t1_ns))
    return {r.id: (r.t1_ns - r.t0_ns) - stats.union_length(
        [(max(s, r.t0_ns), min(e, r.t1_ns)) for s, e in children[r.id] if e > s])
        for r in records}
