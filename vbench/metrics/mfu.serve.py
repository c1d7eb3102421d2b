"""Percent of the bf16 peak: model FLOPs of every prefilled and generated
token of the window's requests over the window's seconds."""
from vbench.readouts import mfu_percent


def read(run):
    return mfu_percent(run.facts.get("model_flops", 0.0), run.window_s)
