"""Wall ms a unit of the quorum hash's device-to-host copies (the
program's ``trainer.hash.copy`` spans, one a gradient leaf): their
seconds in the window over the window's ``trainer.unit`` spans."""
from vbench import program


def read(run):
    units = program.spans(run, "trainer.unit")
    copies = program.spans(run, "trainer.hash.copy")
    if not units or not copies:
        return None
    return program.seconds(copies) / len(units) * 1e3
