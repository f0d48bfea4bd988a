"""cluster_kernel.live_lane_share: the cluster kernel's useful share of
the lanes it was launched on, over the device-profiled calls: the live
rays (n_valid) over the padded launch widths (n_pad) of the program's
trace.kernel spans, one per dispatch."""

from harness import spans


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    launches = [r.attrs for r in records if r.name == "trace.kernel"]
    n_pad = sum(a["n_pad"] for a in launches)
    return sum(a["n_valid"] for a in launches) / n_pad if n_pad else None
