"""Synchronised ms per call of the engine's ``_prefill`` (one request)."""
from vbench.readouts import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine.prefill")
