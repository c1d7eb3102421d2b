"""The program's own wall-clock spans, as the per-layer readers take them:
the default telemetry hub's span ring (``repro_torch.core.telemetry``),
each span ``(name, start, end, thread name)`` on ``time.perf_counter``,
the clock of ``run.window``.

A program without the ring (one that records no spans) gives nothing, so
a reader returns None there, as it does where no span of its name lies
in the window.
"""
from __future__ import annotations

from typing import List


def recorded(name: str) -> List[tuple]:
    """Every span ``name`` the default hub holds: ``(start, end, thread)``
    tuples."""
    from repro_torch.core import telemetry
    ring = getattr(telemetry.get_default(), "spans", None) or ()
    return [(s, e, t) for n, s, e, t in list(ring) if n == name]


def spans(run, name: str) -> List[tuple]:
    """The spans ``name`` that start and end inside ``run.window``."""
    t0, t1 = run.window
    return [(s, e, t) for s, e, t in recorded(name) if s >= t0 and e <= t1]


def seconds(found: List[tuple]) -> float:
    """Summed length of ``found`` spans, in seconds."""
    return sum(e - s for s, e, _ in found)
