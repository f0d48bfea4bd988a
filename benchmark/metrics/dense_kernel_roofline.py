"""dense_kernel_roofline: the dense kernel's share of its roofline, in %,
over its launches in the device-profiled calls: the summed least time of
the launches (harness/dense_work.py: the bytes that a launch of n lanes
must move, over the card's memory rate) over their summed device time
(the CUPTI durations of the events named dense_sweep_kernel).  The
widths are the `n` of the program's dense_trace._sweep spans that
launched (n > 0), in launch order, matched one for one with the events.
The peaks are the published ones (harness/peaks.json); on a card without
an entry there, on a program whose spans carry no width (an older
commit), or where the launches and the traced kernels differ in number,
nothing is read."""

from harness import dense_work, spans, work

KERNEL = "dense_sweep_kernel"
SPAN = "dense_trace._sweep"


def read(rec):
    if rec.trace is None or rec.peak is None:
        return None
    records = spans.device_profiled(rec)
    if records is None:
        return None
    widths = [r.attrs["n"] for r in records if r.name == SPAN and r.attrs.get("n", 0) > 0]
    secs = [e - s for s, e, n in rec.trace.device if KERNEL in n]
    if not widths or len(secs) != len(widths) or sum(secs) <= 0:
        return None
    least = sum(work.bound_s(dense_work.launch_bytes(n), rec.peak) for n in widths)
    return 100.0 * least / sum(secs)
