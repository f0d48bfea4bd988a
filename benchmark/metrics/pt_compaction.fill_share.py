"""pt_compaction.fill_share: how close pt_rgb's per-frame compaction
schedule runs to killing paths: Σ `live` (the live lanes before a
compaction, a device scalar that a recording pt.flush_compact span of
pt_rgb.trace_paths carries) over Σ `width_out` (the lanes it keeps),
over the pt.flush_compact spans with `live` in the device-profiled
calls.  Above 1 only where a compaction cut live paths.  None where
there is no such span (an older program, or no per-frame schedule)."""

import torch

from harness import spans

SPAN = "pt.flush_compact"


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    phases = [r.attrs for r in records if r.name == SPAN and "live" in r.attrs]
    width = sum(a["width_out"] for a in phases)
    if not width:
        return None
    live = int(torch.stack([a["live"] for a in phases]).sum())
    return live / width
