"""Whole-window statistics: percentiles over every sample, the spread
that sets a bound, and unions of device intervals."""

import math
import statistics


def percentile(values, q):
    """The ``q``-th percentile (0-100) of all ``values``, interpolated
    linearly between the two nearest ranks."""
    data = sorted(values)
    if not data:
        raise ValueError("percentile of no values")
    pos = (len(data) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(data) - 1)
    return data[lo] + (data[hi] - data[lo]) * (pos - lo)


def spread(values):
    """Distance between the first and third quartiles, as
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def merged(intervals):
    """Sorted, disjoint (start, end) covering the same points."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def union_length(intervals):
    """Length of the union of (start, end) intervals: time covered by at
    least one, overlaps counted once."""
    return sum(t - s for s, t in merged(intervals))


def gaps_of(intervals, start, end):
    """(start, end) pieces of [start, end] that no interval covers."""
    gaps, cursor = [], start
    for s, t in merged(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, t)
    if cursor < end:
        gaps.append((cursor, end))
    return [(s, t) for s, t in gaps if t > s]
