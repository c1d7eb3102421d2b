"""The arithmetic of the end-to-end metrics, on host-clock timelines.

Every rate is all the work of the window over all its time, and every
tail is the tail of all samples: nothing is taken from medians of pieces.
"""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The q-th percentile (0..100), linear between the two nearest ranks
    (numpy's default): rank q/100 * (n - 1) of the sorted values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    r = q / 100 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def completed_rate(start: float, ends: Sequence[float], work: Sequence[float],
                   window_end: float, period: int = 1) -> tuple:
    """Work per second over the pieces that completed by ``window_end``,
    in whole periods of ``period`` pieces from the first: (rate, work
    counted, seconds), the seconds from ``start`` to the end of the last
    piece counted.  A stall inside the window lengthens the seconds, so it
    lowers the rate; a stall that comes once a period weighs the same
    whichever piece the window ends on."""
    done = [(e, w) for e, w in zip(ends, work) if e <= window_end]
    done = done[:len(done) // period * period]
    if not done:
        return 0.0, 0.0, 0.0
    total = sum(w for _, w in done)
    secs = max(e for e, _ in done) - start
    return total / secs, total, secs


def batch_rate(start: float, end: float, work: float) -> float:
    """Work per second of closed batches run from ``start`` to ``end``."""
    return work / (end - start)


def token_gaps(token_times: List[List[float]]) -> List[float]:
    """The gaps between consecutive tokens of each request, all requests'
    gaps together."""
    return [b - a for ts in token_times for a, b in zip(ts, ts[1:])]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles over the median, by
    ``statistics.quantiles(values, n=4)`` (the exclusive method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
