"""shadow_cap.fill_share: the share of the lanes that the capped shadow
sweeps ran on that carry a shadow ray: Σ `n_active` (the active lanes of
the uncapped batch, a device scalar that a recording capped
dense_trace._sweep span carries on the card) over Σ `n` (the lanes after
the cap), over the spans with `capped=True` in the device-profiled
calls.  At most 1 wherever the cap killed no lane.  None where there is
no such span or one carries no `n_active` (an older program, or the
CPU)."""

import torch

from harness import capped_sweep


def read(rec):
    capped = capped_sweep.capped_spans(rec)
    if capped is None or any("n_active" not in a for a in capped):
        return None
    lanes = sum(a["n"] for a in capped)
    if not lanes:
        return None
    active = int(torch.stack([a["n_active"] for a in capped]).sum())
    return active / lanes
