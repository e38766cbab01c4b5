"""host_ms.upblock: host milliseconds a call inside ``attngan.upblock``
(``UpBlock.forward`` on every route, the K2 wrapper included)."""

from perfbench.spans import UPBLOCK, host_ms


def read(r):
    return host_ms(r, UPBLOCK)
