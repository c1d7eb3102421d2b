"""Mean wall ms of a snapshot's write (the program's ``snapshot.write``
span: chunking, hashing, RLE, store and manifest, on the writer's thread
with the async writer) over the writes that start and end in the
window."""
from vbench import program


def read(run):
    writes = program.spans(run, "snapshot.write")
    if not writes:
        return None
    return program.seconds(writes) / len(writes) * 1e3
