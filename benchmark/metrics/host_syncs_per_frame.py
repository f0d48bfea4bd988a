"""host_syncs_per_frame: reads of a device value by the host (each drains
the card's queue) in the device-profiled calls over their frames: the
count of the program's sync.* spans."""

from harness import spans


def read(rec):
    records = spans.device_profiled(rec)
    if records is None:
        return None
    return sum(r.name.startswith("sync.") for r in records) / rec.trace_frames
