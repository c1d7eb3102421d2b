"""Percent of the bf16 peak: model FLOPs of the window's completed units
(6 N D plus attention) over the seconds to the end of the last of them."""
from vbench.readouts import mfu_percent


def read(run):
    f = run.facts
    if not f.get("rounds_done"):
        return None
    flops = f["rounds_done"] * f["units_per_round"] * f["flops_per_unit"]
    return mfu_percent(flops, f["seconds_done"])
