"""dense_kernel.culled_share: the share of the dense kernel's (warp, group)
pairs that its cull skipped, over its launches in the device-profiled
calls: 1 - the pairs tested (the first of the kernel's own counts, which
the program's dense_trace._sweep span carries as a device tensor while
it records) over all pairs (harness/dense_work.warp_group_pairs of each
span's `n` and `groups`).  None where a span carries no counts (an older
commit, or a sweep on the CPU)."""

import torch

from harness import dense_work, spans

SPAN = "dense_trace._sweep"


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    sweeps = [r.attrs for r in records if r.name == SPAN]
    if not sweeps or any("counts" not in a for a in sweeps):
        return None
    pairs = sum(dense_work.warp_group_pairs(a["n"], a["groups"]) for a in sweeps)
    if not pairs:
        return None
    tested = int(torch.stack([a["counts"][0] for a in sweeps]).sum())
    return 1.0 - tested / pairs
