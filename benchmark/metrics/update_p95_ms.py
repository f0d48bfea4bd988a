"""update_p95_ms: the 95th percentile, over every update of a preview
window, of the interval from one displayed update to the next (one call,
its readback to uint8 on the host, and the synchronize); host clock."""

from harness import stats


def read(rec):
    if not rec.workload.get("readback") or not rec.intervals:
        return None
    return stats.percentile(rec.intervals, 95) * 1e3
