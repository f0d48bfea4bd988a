"""preview.readback_ms: the median, over the untraced updates of a traced
preview run, of the host span from a synchronize to the uint8 image on
the host: film.to_srgb, the copy to the host and the conversion."""

import statistics


def read(rec):
    spans = rec.readback_s[:rec.untraced_calls]
    return statistics.median(spans) * 1e3 if spans else None
