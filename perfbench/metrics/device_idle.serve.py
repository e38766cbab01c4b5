"""device_idle.serve: 1 - (union of device operations) / (profiled wall time)."""

from perfbench.metrics import idle_percent as read  # noqa: F401
