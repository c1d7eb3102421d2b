"""Device operations a decode step launches: the device trace's
operations that start inside one of the program's ``engine.step`` spans,
over the steps that lie wholly inside the traced part of the window.  A
step ends with its tokens' readback, which waits for the device, so each
of its operations starts inside it."""
import bisect

from vbench import program


def read(run):
    if run.tracer is None:
        return None
    t0, t1 = run.traced
    steps = sorted((s, e) for s, e, _ in program.spans(run, "engine.step")
                   if s >= t0 and e <= t1)
    if not steps:
        return None
    starts = sorted(s for _, s, _ in run.tracer.events)
    ops = sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s)
              for s, e in steps)
    return ops / len(steps)
