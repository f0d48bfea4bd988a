"""nee_sweep.ms_per_frame: device time of the dense kernel's NEE shadow
sweeps (csrc/dense_trace.cu under pt_rgb's `pt.shadow` span) in the
profiled calls over their frames: the CUPTI durations of the
dense_sweep_kernel events paired with the launching spans whose parent
is `pt.shadow` (harness/nee_sweep.py).  Where the profile lost some of
those events, the time of the rest is scaled by the lanes of all NEE
launches over theirs.  None where nothing pairs."""

from harness import nee_sweep


def read(rec):
    found = nee_sweep.nee_launches(rec)
    if found is None or not rec.trace_frames:
        return None
    picked, lanes = found
    secs = sum(s for _, s in picked) * lanes / sum(a["n"] for a, _ in picked)
    return secs / rec.trace_frames * 1e3 if secs > 0 else None
