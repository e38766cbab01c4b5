"""mfu.serve: the reference's FLOPs a call over the unprofiled wall time a call,
as a share of 989 TFLOP/s."""

from perfbench.metrics import mfu_percent as read  # noqa: F401
