"""shadow_sweep.culled_share: the share of the dense kernel's (warp, group)
pairs that its cull skipped on the capped shadow sweeps of the
device-profiled calls: 1 - the pairs tested (the first of the kernel's
own counts, which a recording dense_trace._sweep span carries on the
card as a device tensor) over all pairs (harness/dense_work.
warp_group_pairs of each span's `n` and `groups`), over the spans with
`capped=True`.  None where there is no such span or one carries no
counts (an older program, or a sweep on the CPU)."""

import torch

from harness import capped_sweep, dense_work


def read(rec):
    capped = capped_sweep.capped_spans(rec)
    if capped is None or any("counts" not in a for a in capped):
        return None
    pairs = sum(dense_work.warp_group_pairs(a["n"], a["groups"]) for a in capped)
    if not pairs:
        return None
    tested = int(torch.stack([a["counts"][0] for a in capped]).sum())
    return 1.0 - tested / pairs
