"""walk_compaction.fill_share: how close the BDPT walk compaction's
schedule runs to killing paths: Σ `live` (a front's live lanes before it
is compacted, a device scalar that a recording bdpt.compact_walk span
carries on the card) over Σ `capacity` (the lanes it is compacted to),
over the program's bdpt.compact_walk spans in the device-profiled calls.
Above 1 only where a compaction cut live paths.  None where there is no
such span or one carries no `live` (an older program, or the CPU)."""

import torch

from harness import spans

SPAN = "bdpt.compact_walk"


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    fronts = [r.attrs for r in records if r.name == SPAN]
    if not fronts or any("live" not in a for a in fronts):
        return None
    capacity = sum(a["capacity"] for a in fronts)
    if not capacity:
        return None
    live = int(torch.stack([a["live"] for a in fronts]).sum())
    return live / capacity
