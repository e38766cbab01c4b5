"""memread_roofline: the memory form's bounds (counts/dmgan.py: operations
at 989 TFLOP/s or bytes at 3.35 TB/s, the larger) over its summed device
time."""

from perfbench.metrics import roofline_percent


def read(r):
    return roofline_percent(r, "memread", "memread")
