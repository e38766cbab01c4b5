"""graph_replay.serve: the share of the traced calls, in %, whose generator
replayed a CUDA graph: an ``attngan.replay`` range inside the call's
``attngan.serve``. 0 where the port never replays; None where the calls
opened no ``attngan.serve`` (``spans.served``)."""

from perfbench.spans import inside, named, served

REPLAY = "attngan.replay"


def read(r):
    calls = served(r.trace)
    if calls is None:
        return None
    return 100.0 * len(inside(named(r.trace, REPLAY), calls)) / r.trace.calls
