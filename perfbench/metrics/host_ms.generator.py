"""host_ms.generator: the generator's own host milliseconds a call,
``attngan.generator`` less the ``attngan.upblock`` ranges inside it."""

from perfbench.spans import generator_self_ms as read  # noqa: F401
