"""Percent of the window's decode calls (the program's
``engine.step.dispatch`` spans) that replayed the engine's CUDA graph:
those holding an ``engine.step.replay`` span."""
import bisect

from vbench import program


def read(run):
    calls = program.spans(run, "engine.step.dispatch")
    if not calls:
        return None
    starts = sorted(s for s, _, _ in program.spans(run, "engine.step.replay"))
    held = sum(bisect.bisect_right(starts, e) > bisect.bisect_left(starts, s)
               for s, e, _ in calls)
    return 100.0 * held / len(calls)
