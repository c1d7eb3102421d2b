"""Helpers the per-layer metric readers (``metrics/<name>.py``) share.

Each returns None where the run holds nothing to read: a reader never
makes up a 0.
"""
from __future__ import annotations

from typing import List, Optional

from vbench import costs


def spans_in_window(run, name: str) -> List[tuple]:
    t0, t1 = run.window
    return [(s, e) for s, e in run.spans.get(name) if s >= t0 and e <= t1]


def mean_span_ms(run, name: str) -> Optional[float]:
    spans = spans_in_window(run, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e3


def covered(spans: List[tuple], start: float, end: float) -> float:
    """Seconds of [start, end] that ``spans`` (disjoint) cover."""
    return sum(max(0.0, min(e, end) - max(s, start)) for s, e in spans)


def roofline(run, kernel: str, needle: str) -> Optional[float]:
    """Percent: the kernel's bound (``vbench.costs``) summed over its
    launches while the device trace ran, over the device time of the
    kernels whose name holds ``needle`` in that trace."""
    calls = run.kernel_calls.get(kernel, [])
    if run.tracer is None or not calls:
        return None
    device_s = run.tracer.kernel_seconds(*run.traced, needle)
    if device_s <= 0:
        return None
    return 100.0 * sum(c["bound_s"] for c in calls) / device_s


def idle_percent(run) -> Optional[float]:
    if run.device is None or run.device["window_s"] <= 0:
        return None
    return 100.0 * (1 - run.device["busy_s"] / run.device["window_s"])


def mfu_percent(flops: float, seconds: float) -> Optional[float]:
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / (seconds * costs.PEAK_BF16_FLOPS)
