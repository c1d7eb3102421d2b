"""90th percentile, in ms, of the window's requests' wait from their
hand-off to their admission (the program's ``engine.queue`` spans)."""
from vbench import program, stats


def read(run):
    waits = program.spans(run, "engine.queue")
    if not waits:
        return None
    return stats.percentile([e - s for s, e, _ in waits], 90) * 1e3
