"""dfblock_roofline: K7's bounds (counts/dfgan.py: bytes at 3.35 TB/s) over
K7's summed device time."""

from perfbench.metrics import roofline_percent


def read(r):
    return roofline_percent(r, "dfblock", "dfblock")
