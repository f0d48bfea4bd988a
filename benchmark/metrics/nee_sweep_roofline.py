"""nee_sweep_roofline: the dense kernel's share of its roofline, in %, on
NEE's shadow sweeps of the device-profiled calls: the summed least time
of those launches (harness/dense_work.launch_bytes of each span's `n`
over the card's memory rate, harness/peaks.json) over their summed CUPTI
durations (harness/nee_sweep.py pairs them; launches whose events the
profile lost count on neither side).  It reads only the widths, so no
cull can push it past 100%.  None on a card without a peak, or where
nothing pairs."""

from harness import dense_work, nee_sweep, work


def read(rec):
    if rec.peak is None:
        return None
    found = nee_sweep.nee_launches(rec)
    if found is None:
        return None
    picked, _ = found
    secs = sum(s for _, s in picked)
    if secs <= 0:
        return None
    least = sum(work.bound_s(dense_work.launch_bytes(a["n"]), rec.peak) for a, _ in picked)
    return 100.0 * least / secs
