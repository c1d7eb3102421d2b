"""Mean ``RoundStats.snapshot_stall_ms`` (the program's own timing of the
snapshot call inside ``round``) over the window's snapshot rounds."""


def read(run):
    stalls = run.spans.counters.get("snapshot_stall_ms", [])
    return sum(stalls) / len(stalls) if stalls else None
