"""Wall ms a unit of the quorum hash's blake2b updates (the program's
``trainer.hash.digest`` spans, one a gradient leaf): their seconds in the
window over the window's ``trainer.unit`` spans."""
from vbench import program


def read(run):
    units = program.spans(run, "trainer.unit")
    digests = program.spans(run, "trainer.hash.digest")
    if not units or not digests:
        return None
    return program.seconds(digests) / len(units) * 1e3
