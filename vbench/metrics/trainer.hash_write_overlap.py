"""Percent of the window's quorum-hash seconds (``trainer.hash.copy`` and
``trainer.hash.digest`` spans) during which a ``snapshot.write`` span was
open on another thread: how much of the hash ran beside the snapshot
writer."""
from vbench import program
from vbench.readouts import covered


def read(run):
    hashing = (program.spans(run, "trainer.hash.copy")
               + program.spans(run, "trainer.hash.digest"))
    total = program.seconds(hashing)
    if total <= 0:
        return None
    writes = program.recorded("snapshot.write")
    beside = sum(covered([(ws, we) for ws, we, wt in writes if wt != t],
                         s, e) for s, e, t in hashing)
    return 100.0 * beside / total
