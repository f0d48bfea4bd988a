"""shadow_sweep.ms_per_frame: device time of the dense kernel's capped
shadow sweeps (csrc/dense_trace.cu under ops/dense_trace.
trace_planar_capped: the BDPT shadow batch packed to its cap) in the
profiled calls over their frames: the CUPTI durations of the
dense_sweep_kernel events matched with the launching spans that carry
`capped=True` (harness/capped_sweep.py).  None where nothing matches."""

from harness import capped_sweep


def read(rec):
    picked = capped_sweep.capped_launches(rec)
    if picked is None or not rec.trace_frames:
        return None
    secs = sum(s for _, s in picked)
    return secs / rec.trace_frames * 1e3 if secs > 0 else None
