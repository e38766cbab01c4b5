"""upblock_roofline: K2's bounds (counts/kernels.py) over K2's summed device time."""

from perfbench.metrics import roofline_percent


def read(r):
    return roofline_percent(r, "upblock", "upblock")
