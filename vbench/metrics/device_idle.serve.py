"""Percent of the traced window in which no operation ran on the device."""
from vbench.readouts import idle_percent


def read(run):
    return idle_percent(run)
