"""NEE's shadow sweeps of the device-profiled calls, for the
`nee_sweep.*` metrics: the program's dense_trace._sweep spans whose
parent is a `pt.shadow` span (integrators/pt_rgb._shadow_trace, the
shadow rays of next-event estimation on the dense tracer), and the
CUPTI durations of their dense-kernel launches.

The launching spans (n > 0), in the order they closed, are paired with
the events named dense_sweep_kernel in the order they started: one for
one where their numbers agree, as `harness/capped_sweep.py` pairs them.
A 32-frame call makes ~120k device events, and the profiler often loses
stretches of them (on an H100, 30 of 78 such calls lost 1 to 33 of their
960 sweeps' events).  Where there are fewer events than launches, the
pairing skips as many launches as were lost, where the time from each
event to the next best matches the time from its launch to the next
one's (`pair`): differences of times on each clock, since the device's
clock can stand milliseconds off the host's and drift within a call.
Those under `pt.shadow` are picked out.  None where the program recorded
no such span, or where there are more events than launches."""

from harness import spans

KERNEL = "dense_sweep_kernel"
SPAN = "dense_trace._sweep"
PARENT = "pt.shadow"


def pair(launched, events):
    """[(span, seconds)]: the launching spans `launched` (in launch order)
    paired with the kernel events [(start_s, end_s)] (in start order), or
    None where there are more events than launches.  With `lost` fewer
    events, the pairing (event j with launch j + d_j, d_j not decreasing
    and at most `lost`) is the one that least sums, over consecutive
    events, |their start's step - their launches' step|."""
    lost = len(launched) - len(events)
    if lost < 0:
        return None
    if not lost:
        return [(r, e - s) for r, (s, e) in zip(launched, events)]
    t0 = [r.t0_ns * 1e-9 for r in launched]
    cost = [0.0] * (lost + 1)  # cost[d]: the least sum with this event at launch j + d
    back = []
    for j in range(1, len(events)):
        step = events[j][0] - events[j - 1][0]
        new, arg = [], []
        for d in range(lost + 1):
            c, d0 = min((cost[d0] + abs(step - (t0[j + d] - t0[j - 1 + d0])), d0)
                        for d0 in range(d + 1))
            new.append(c)
            arg.append(d0)
        cost = new
        back.append(arg)
    d = min(range(lost + 1), key=cost.__getitem__)
    skips = [d]
    for arg in reversed(back):
        d = arg[d]
        skips.append(d)
    return [(launched[j + d], e - s)
            for j, ((s, e), d) in enumerate(zip(events, reversed(skips)))]


def nee_launches(rec):
    """([(span attributes, kernel seconds)] of NEE's shadow sweeps whose
    kernel events the profile holds, the lanes of all of NEE's sweeps),
    or None."""
    if rec.trace is None:
        return None
    records = spans.device_profiled(rec)
    if records is None:
        return None
    shadow = {r.id for r in records if r.name == PARENT}
    launched = [r for r in records if r.name == SPAN and r.attrs.get("n", 0) > 0]
    events = [(s, e) for s, e, n in rec.trace.device if KERNEL in n]
    nee = [r for r in launched if r.parent in shadow]
    paired = pair(launched, events) if nee and events else None
    if paired is None:
        return None
    picked = [(r.attrs, secs) for r, secs in paired if r.parent in shadow]
    return (picked, sum(r.attrs["n"] for r in nee)) if picked else None
