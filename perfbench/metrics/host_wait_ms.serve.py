"""host_wait_ms.serve: host milliseconds a call inside the blocking calls
that ``host_syncs.serve`` counts."""

from perfbench.spans import wait_ms as read  # noqa: F401
