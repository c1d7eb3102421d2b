"""Percent of ``ssm_scan``'s bound (its bytes at the memory rate, or its
float32 operations where larger) over its device time in the window's
trace, summed over the prefills' launches."""
from vbench.readouts import roofline


def read(run):
    return roofline(run, "ssm_scan", "scan_kernel")
