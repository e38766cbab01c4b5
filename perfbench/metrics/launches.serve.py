"""launches.serve: device kernels a call, from the profiled sub-window."""

from perfbench.metrics import launches as read  # noqa: F401
