"""Synchronised ms per call of the session's ``grad_fn`` (forward,
backward, on one unit)."""
from vbench.readouts import mean_span_ms


def read(run):
    return mean_span_ms(run, "model.grad_fn")
