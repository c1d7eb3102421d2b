"""Percent of ``flash_attention``'s bound (the larger of its operations
at the bf16 peak and its bytes at the memory rate) over its device time
in the window's trace, summed over the prefills' launches."""
from vbench.readouts import roofline


def read(run):
    return roofline(run, "flash_attention", "attn_fwd")
