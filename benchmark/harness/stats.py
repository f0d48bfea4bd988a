"""The yardstick's arithmetic: percentiles over all samples and the union
of device intervals and the gaps between them."""


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every value, by linear
    interpolation between order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps counted
    once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The (start, end) stretches of [start, end] that no interval
    covers, in order."""
    out = []
    t = start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
