"""shadow_sweep_roofline: the dense kernel's share of its roofline, in %,
on the capped shadow sweeps of the device-profiled calls: the summed
least time of those launches (harness/dense_work.launch_bytes of each
span's `n`, the lanes swept after the cap, over the card's memory rate,
harness/peaks.json) over their summed CUPTI durations
(harness/capped_sweep.py matches them).  It reads only the widths, so no
cull can push it past 100%.  None on a card without a peak, or where
nothing matches."""

from harness import capped_sweep, dense_work, work


def read(rec):
    if rec.peak is None:
        return None
    picked = capped_sweep.capped_launches(rec)
    if picked is None:
        return None
    secs = sum(s for _, s in picked)
    if secs <= 0:
        return None
    least = sum(work.bound_s(dense_work.launch_bytes(a["n"]), rec.peak) for a, _ in picked)
    return 100.0 * least / secs
