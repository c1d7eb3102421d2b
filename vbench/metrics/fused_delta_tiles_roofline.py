"""Percent of ``fused_delta_tiles``'s bytes bound (old and new read, the
changed tiles and the bitmap written, at the memory rate) over its device
time in the window's trace."""
from vbench.readouts import roofline


def read(run):
    return roofline(run, "fused_delta_tiles", "fused_tiles")
