"""Synchronised ms per call of the engine's ``_decode`` (one step of
every slot)."""
from vbench.readouts import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine.decode")
