"""host_syncs.serve: blocking CUDA runtime calls (stream, device and event
synchronizes, the synchronous cudaMemcpy) started inside ``attngan.serve``,
a call."""

from perfbench.spans import syncs_per_call as read  # noqa: F401
