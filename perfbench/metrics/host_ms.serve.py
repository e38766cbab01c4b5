"""host_ms.serve: host milliseconds a call inside ``attngan.serve``
(``Sampler.generate_stages``), from the traced calls."""

from perfbench.spans import SERVE, host_ms


def read(r):
    return host_ms(r, SERVE)
