"""Mean wall ms the host spends in the engine's decode call (the
program's ``engine.step.dispatch`` span: enqueueing a step's operations,
and any wait inside it), unsynchronised."""
from vbench import program


def read(run):
    calls = program.spans(run, "engine.step.dispatch")
    if not calls:
        return None
    return program.seconds(calls) / len(calls) * 1e3
