"""device_idle_share: the share of the window's time in which the card
runs nothing: 1 - the union of the card's activity intervals in the
device-profiled calls (torch.profiler, CUPTI) over the wall time that as
many calls take in the window (the median untraced call's, times their
number).  The profiled calls' own wall time is not the denominator: the
profiler's recording slows these host-bound calls by a third or more,
and that time is idle to the card."""


def read(rec):
    if rec.trace is None or not rec.trace.device or not rec.untraced_call_s:
        return None
    return 1.0 - rec.trace.busy_s() / (rec.traced_calls * rec.untraced_call_s)
