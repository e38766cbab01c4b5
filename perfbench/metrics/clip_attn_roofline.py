"""clip_attn_roofline: K11's bounds (counts/galip.py: operations at 989
TFLOP/s or bytes at 3.35 TB/s, the larger; bytes bound it) over its
summed device time."""

from perfbench.metrics import roofline_percent


def read(r):
    return roofline_percent(r, "clip_attn", "clip_attn")
